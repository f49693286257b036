"""Smoke run of moai_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the NTT kernels (moai_tpu_torch/csrc/ntt.cu) with nvcc for sm_90a.
2. N=2^16: builds a flagship_config context (87 Q+P primes) and holds each
   kernel against its plain PyTorch version over all its limbs and on limb
   slices; they must be equal (torch.equal).  Times both at [8, 2, 87,
   2^16] beside the memory bound (one call per CUDA-event pair, and the
   device time per call of each of its two kernels from torch.profiler),
   and drives ntt/intt (the dispatching entry points) once with the launch
   counts set to 0 just before: each kernel must have launched, and
   intt(ntt(x)) == x.
3. The same check and timing at N=2^15 over all 45 limbs of the head's
   chain and on limb slices, at [8, 2, 45, 2^15].
4. Runs the encrypted attention head at BERT-base head width (d_model 768,
   head_dim 64, 128 tokens, 128 interleaved inputs, logN 15, L 34) with
   weights drawn at BERT-base magnitude, decrypts, and compares with the
   float64 oracle.  Both kernels must have launched during the head.
5. Runs the head once more under torch.profiler: device time by kernel and
   the device's busy share.

Prints a {"kernels": [...]} line (one row per kernel and shape: the
N=2^15 rows carry the head's launch counts, the N=2^16 rows those of the
N=2^16 entry-point run), the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
HEAD = dict(logN=15, n_data_levels=16, num_x=128, num_row=128, d_model=768,
            head_dim=64, exp_r=5, inv_iters=4, input_count=128)
# Decrypted head output vs the float64 oracle, absolute, on outputs of
# magnitude ~1: the JAX package's own encrypted-matmul tests hold decrypted
# results to 1e-3 at this scale (2^52); the head adds the exp and inverse
# polynomials, which the oracle repeats exactly, so CKKS noise and the
# 2^-26 weight/mask quantization are what remain.
HEAD_ATOL = 1e-3
KERNELS = {
    "ntt_fwd": "moai_tpu/pallas_ntt.py:282",
    "ntt_inv": "moai_tpu/pallas_ntt.py:301",
}


def log(*a):
    print(*a, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 7) -> float:
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_name(key: str) -> str:
    """A profiler key without namespace, return type and arguments."""
    return key.replace("(anonymous namespace)::", "").replace(
        "void ", "").split("(")[0]


def device_ms(fn, calls: int = 10) -> dict:
    """Device time per call of each CUDA kernel that fn() launches, from
    torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {kernel_name(e.key): e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def random_residues(qs: torch.Tensor, lead: tuple, N: int) -> torch.Tensor:
    """Uniform residues [*lead, len(qs), N], row l below qs[l], on the card."""
    r = torch.randint(0, 1 << 62, lead + (len(qs), N), dtype=torch.int64,
                      device=qs.device)
    return r.remainder_(qs.reshape(-1, 1))


def check_kernels(ctx) -> dict:
    """Kernel vs plain on the card; returns per-kernel measurements."""
    from moai_tpu_torch import ntt as nt
    from moai_tpu_torch import ntt_cuda
    tb = ctx.dev["ntt"]
    cuda_tb = tb["cuda"]
    nall, N = ctx.L + ctx.K, ctx.cfg.N
    torch.manual_seed(0)
    x = random_residues(tb["q"], (8, 2), N)          # 8 ciphertexts, Q+P
    cases = [((0, nall), x), ((ctx.L, nall), x[..., ctx.L:, :]),
             ((5, 17), x[0, :, 5:17, :].contiguous())]
    res = {}
    for name, kern, plain in (("ntt_fwd", ntt_cuda.ntt_cuda, nt.ntt_plain),
                              ("ntt_inv", ntt_cuda.intt_cuda,
                               nt.intt_plain)):
        err = 0
        for sl, xi in cases:
            xi = xi.contiguous()
            got = kern(xi, cuda_tb, sl)
            want = plain(xi, tb, sl)
            torch.cuda.synchronize()
            err = max(err, int((got - want).abs().max()))
            if not torch.equal(got, want):
                raise SystemExit(f"{name} differs from its plain version "
                                 f"on limbs {sl}: max |diff| {err}")
        ms = time_ms(lambda: kern(x, cuda_tb))
        dev = device_ms(lambda: kern(x, cuda_tb))
        plain_ms = time_ms(lambda: plain(x, tb), reps=3)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, shape=list(x.shape), device_ms=dev)
        log(f"{name} N=2^{ctx.cfg.logN}: equal to plain on limbs "
            f"{[c[0] for c in cases]}; {tuple(x.shape)}: kernel {ms:.3f} ms, "
            f"device {json.dumps(dev)}, plain {plain_ms:.3f} ms, memory "
            f"bound {bound:.3f} ms")
    fwd = ntt_cuda.ntt_cuda(x, cuda_tb)
    if not torch.equal(ntt_cuda.intt_cuda(fwd, cuda_tb), x):
        raise SystemExit("intt(ntt(x)) != x on the card")
    log("round trip intt(ntt(x)) == x")
    return res


def flagship_ntt() -> dict:
    """The N=2^16 phase on a flagship_config context: kernels against the
    plain transforms and timed, then the ntt/intt entry points once with
    the counts set to 0 just before and read just after; each kernel's
    measurements carry the launches of that run."""
    from moai_tpu_torch import ntt as nt
    from moai_tpu_torch import ntt_cuda
    from moai_tpu_torch.params import Context, flagship_config
    t0 = time.time()
    ctx = Context(flagship_config(), device="cuda")
    log(f"flagship context (logN 16, L={ctx.L} K={ctx.K}) "
        f"{time.time() - t0:.1f} s")
    kern = check_kernels(ctx)
    tb = ctx.dev["ntt"]
    x = random_residues(tb["q"], (2, 2), ctx.cfg.N)
    ntt_cuda.reset_launches()
    back = nt.intt(nt.ntt(x, tb), tb)
    torch.cuda.synchronize()
    counts = dict(ntt_cuda.launches)
    log(f"N=2^16 entry points: launches {counts}")
    if counts != {"ntt_fwd": 1, "ntt_inv": 1}:
        raise SystemExit("ntt/intt at N=2^16 did not go through the kernels")
    if not torch.equal(back, x):
        raise SystemExit("intt(ntt(x)) != x at N=2^16")
    for k in KERNELS:
        kern[k]["launches"] = counts[k]
    return kern


def profile_head(head) -> dict:
    """One more run of the head under torch.profiler: device time by kernel
    (top 10, and every NTT kernel) and the device's busy share of the wall
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        head.fn(head.x_data)
        torch.cuda.synchronize()
        wall = time.time() - t0
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total / 1e6, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "top": [{"s": s, "calls": n, "name": k[:80]}
                    for s, n, k in rows[:10]],
            "ntt": [{"s": s, "calls": n, "name": kernel_name(k)}
                    for s, n, k in rows if "ntt_" in k]}


def bert_weights(rng, d_model: int, head_dim: int) -> dict:
    """Q/K/V weights and biases at BERT-base magnitude (std 0.036 weights,
    0.02 biases), 1/sqrt(head_dim) folded into W_Q and b_Q."""
    s = np.sqrt(head_dim)
    return dict(wq=rng.normal(0, 0.036, (d_model, head_dim)) / s,
                bq=rng.normal(0, 0.02, head_dim) / s,
                wk=rng.normal(0, 0.036, (d_model, head_dim)),
                bk=rng.normal(0, 0.02, head_dim),
                wv=rng.normal(0, 0.036, (d_model, head_dim)),
                bv=rng.normal(0, 0.02, head_dim))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from moai_tpu_torch import ntt_cuda
    from moai_tpu_torch.entry import build_head

    t0 = time.time()
    lib, msgs = ntt_cuda.build()
    log(f"built {lib.name} in {time.time() - t0:.1f} s")
    for line in msgs.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log("  nvcc:", line.strip())
    name_power = card()
    log(f"card: {name_power}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    kern16 = flagship_ntt()
    torch.cuda.empty_cache()

    t0 = time.time()
    head = build_head(**HEAD, device="cuda",
                      weights=bert_weights(np.random.default_rng(0),
                                           HEAD["d_model"], HEAD["head_dim"]))
    torch.cuda.synchronize()
    log(f"head set-up (context, keys, weights, encrypt) "
        f"{time.time() - t0:.1f} s; L={head.ctx.L} K={head.ctx.K} "
        f"x {tuple(head.x_data.shape)}")

    kern = check_kernels(head.ctx)

    ntt_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    out = head.fn(head.x_data)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(ntt_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"head: {secs:.2f} s, {secs / HEAD['input_count']:.4f} s per input, "
        f"peak {peak / 2**30:.2f} GiB, output n_q={out.n_q}, "
        f"launches {launches}")
    for k in KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{k} was not launched by the head")
        kern[k]["launches"] = launches[k]

    got = head.decode(out)
    want = head.oracle()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise SystemExit(f"head output {got.shape} not finite / not "
                         f"{want.shape}")
    err = float(np.abs(got - want).max())
    log(f"head vs float64 oracle: max |err| {err:.3e} (tolerance "
        f"{HEAD_ATOL}), max |out| {np.abs(want).max():.3f}")
    if err > HEAD_ATOL:
        raise SystemExit("head output outside tolerance")
    del out
    log("profile:", json.dumps(profile_head(head)))

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": "moai_tpu_torch/csrc/ntt.cu",
         "replaces": KERNELS[k], "launches": m[k]["launches"],
         "max_abs_err": m[k]["max_abs_err"], "ms": m[k]["ms"],
         "plain_ms": m[k]["plain_ms"], "bound_ms": m[k]["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "shape": m[k]["shape"], "device_ms": m[k]["device_ms"]}
        for m in (kern, kern16) for k in KERNELS]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
