"""Smoke run of moai_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [bootstrap] [head] [model] [layer]

With no argument it runs bootstrap, head and model, in this order; naming
phases runs only those (``layer`` runs only when named: the model's layer
0 is the same layer on the same input, and reports the same numbers).

1. Builds the NTT kernels (moai_tpu_torch/csrc/ntt.cu) with nvcc for sm_90a.
2. bootstrap: at N=2^16 on flagship_config (entry.build_bootstrap: 32768
   slots, L 74 = q0 pair + 20 data pairs + 16 boot pairs, K 13, dnum 6,
   Galois keys for every CoeffToSlot/SlotToCoeff step and the conjugation,
   held as int32): set-up seconds (context, key generation, the
   Bootstrapper with its encoded diagonals, encryption); then holds each
   kernel against its plain PyTorch version over all 87 limbs of this
   context and on limb slices (torch.equal), and times both at [8, 2, 87,
   2^16] beside the memory bound (one call per CUDA-event pair, and the
   device time per call of each of its two kernels from torch.profiler);
   then one pass of make_refresh over BOOT_BATCH ciphertexts of U(-0.8,
   0.8) slot values, each its own, from n_q0 + 2 limbs to the 42-limb data
   chain, with the launch counts set to 0 just before (both kernels must
   have launched): seconds per pass, per ciphertext and per stage (ModRaise,
   each CoeffToSlot level, EvalMod real and imaginary, each SlotToCoeff
   level, the card synchronized between stages), the device's busy share
   and top kernels (torch.profiler), peak memory; then the decrypted
   slots against the input (gated, real and imaginary parts), and ModRaise
   on the first ciphertext against the plain path on the CPU (reported).
3. head: the encrypted attention head at BERT-base head width (d_model
   768, head_dim 64, 128 tokens, 128 interleaved inputs, logN 15, L 34)
   with weights drawn at BERT-base magnitude: after set-up, the same check
   and timing on its context (all 45 limbs and slices, [8, 2, 45, 2^15]);
   then one pass with the launch counts set to 0 just before (both kernels
   must have launched), decrypted and compared with the float64 oracle.
4. model: the stacked encoder at full BERT-base width, MODEL_LAYERS of its
   12 layers (entry.build_model: d_model 768, 12 heads of 64, d_inter
   3072, 128 tokens, 128 inputs, logN 15, L 28, DepthPlan(5, 5, 2, 0, 16),
   weights synthesized by load_reference_layer, domains from one
   calibrate_domains over every layer, the harness Recryptor as its
   refresh): set-up seconds, the same kernel check and timing on its
   context (all 38 limbs and slices, [8, 2, 38, 2^15]), then one pass with
   the launch counts set to 0 just before (both kernels must have
   launched).  Layer 0 runs with utils.debug.OpTrace on the evaluator and
   under torch.profiler (device time by kernel and the busy share), the
   later layers on the host clock; each layer's seconds, the seconds
   inside its refreshes, its peak memory (layer 0: by stage).  After each
   layer (EncryptedBertModel's on_layer): its state saved with
   serial.save_layer_state into a temporary directory, loaded back onto
   the card and held torch.equal to the ciphertext in memory (gated), save
   and load seconds and the file's bytes; then the decrypted output
   against the chained float64 oracle (Model.oracle, gated at LAYER_ATOL)
   and against plain_bert_layer chained (reported).  The launches of these
   checks are not counted as the path's.  Ends with the OpTrace summary
   of layer 0: op counts and the lowest n_q.
5. layer (only when named): one encoder layer at the same width and chain
   (entry.build_layer): set-up, the same kernel check, one pass traced by
   torch.profiler, its seconds, peak memory and refresh seconds, the
   decrypted output against the float64 oracle (gated) and against
   plain_bert_layer (reported).

Prints a {"kernels": [...]} line, one row per kernel and path: each row's
check and timings come from that path's context and its launches from
that path's run, then the card's name and power limit, and as its last
line {"ok": true, "device": {...}}.  Exits non-zero, printing no result,
without a CUDA card or without the package beside it.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
LAYER = dict(logN=15, n_data_levels=13, input_count=128)
LAYER_DIMS = dict(num_x=128, num_row=128, d_model=768, num_heads=12,
                  head_dim=64, d_inter=3072)
LAYER_PLAN = dict(exp_r=5, inv_iters=5, ln_newton=2, ln_gold=0,
                  gelu_degree=16)
# Decrypted layer output vs layer_oracle, absolute, on LayerNorm outputs
# (magnitude ~1-4): the head's 1e-3.  The oracle repeats every
# approximation (exp, inverse, the rsqrt's line and Newton steps, the
# degree-16 GELU), and each Recryptor refresh re-encodes at 2^52, so CKKS
# noise, the 2^-26 quantization of weights and masks, and their growth
# through LayerNorm's rsqrt (1/sigma of order 1-2 here) remain: the logN-9
# tests see 4e-9 at 2^52, far inside.
LAYER_ATOL = 1e-3
# The model phase: BERT-base's first MODEL_LAYERS layers of its 12, each
# held to LAYER_ATOL against the chained oracle.
MODEL_LAYERS = 2
# what the layer runs before each of its refreshes
LAYER_STAGES = ["heads: Q/K, QK^T, exp, sums", "heads: inverse, "
                "softmax x V; W_O", "-", "residual, LayerNorm 1",
                "FFN: W_I, GELU, W_F", "-", "residual, LayerNorm 2"]
# The bootstrap phase: ciphertexts per pass, and the limit on the decrypted
# output against the input slots, absolute, for the real and the imaginary
# parts: the JAX package's own bootstraps record 9.4e-4 (real parts) at
# logN 15 and 9.3e-5 on a mixed data/boot chain.
BOOT_BATCH = 2
BOOT_ATOL = 2e-3
KERNELS = {
    "ntt_fwd": "moai_tpu/pallas_ntt.py:282",
    "ntt_inv": "moai_tpu/pallas_ntt.py:301",
}


START = time.time()


def log(*a):
    """Print a line, prefixed with the seconds since the script started."""
    print(f"[{time.time() - START:7.1f} s]", *a, flush=True)


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


def profile_summary(prof, wall: float) -> dict:
    """Device time by kernel from a stopped torch.profiler run, read from
    its raw events (``key_averages()`` parses every event in Python: ~2
    minutes for the half a million kernels of a layer pass): the wall
    time, the top 10 kernels and every NTT kernel, and the device's busy
    share of ``wall``."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0, 0])
            acc[0] += e.duration_ns()
            acc[1] += 1
    rows = sorted(((ns / 1e9, n, k) for k, (ns, n) in by_name.items()),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "kernels": sum(r[1] for r in rows),
            "top": [{"s": s, "calls": n, "name": k[:80]}
                    for s, n, k in rows[:10]],
            "ntt": [{"s": s, "calls": n, "name": kernel_name(k)}
                    for s, n, k in rows if "ntt_" in k]}


def profile_pass(fn):
    """fn() under torch.profiler (device activity only, which traces each
    kernel and leaves the host's ops alone): returns fn's result and
    ``profile_summary``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    return out, profile_summary(prof, wall)


def check_modraise(boot) -> None:
    """ModRaise on the card against the plain path on the CPU, on the first
    ciphertext: its float32 CRT estimate should round every coefficient as
    the CPU does (a rounding tie may differ; EvalMod absorbs it).  Prints
    the first differing index, if any."""
    from moai_tpu_torch.boot.bootstrap import Bootstrapper
    from moai_tpu_torch.ciphertext import Ciphertext
    from moai_tpu_torch.encoder import Encoder
    from moai_tpu_torch.evaluator import Evaluator
    from moai_tpu_torch.params import Context
    t0 = time.time()
    ctx = boot.ctx
    x = Ciphertext(boot.x_data[0, :, :ctx.n_q0].contiguous(), ctx.scale)
    got = boot.bootstrapper.modraise(x).data.cpu()
    cpu = Context(ctx.cfg, device="cpu")
    want = Bootstrapper(Evaluator(cpu, device="cpu"), Encoder(cpu)).modraise(
        Ciphertext(x.data.cpu(), x.scale)).data
    diff = (got != want).nonzero()
    log(f"ModRaise on the card vs the CPU, [2, {ctx.L}, 2^{ctx.cfg.logN}]: "
        + ("equal" if len(diff) == 0 else
           f"{len(diff)} residues differ, the first at "
           f"{diff[0].tolist()}: {int(got[tuple(diff[0])])} vs "
           f"{int(want[tuple(diff[0])])}") + f" ({time.time() - t0:.1f} s)")


def run_bootstrap() -> dict:
    """The bootstrap phase: set-up, kernels against plain on its context,
    one timed and traced pass with the launch counts set to 0 just before,
    the check against the input.  Returns the kernels' measurements with
    the pass's launches."""
    from moai_tpu_torch import ntt_cuda
    from moai_tpu_torch.entry import build_bootstrap
    from moai_tpu_torch.params import flagship_config
    t0 = time.time()
    boot = build_bootstrap(flagship_config(), BOOT_BATCH, device="cuda")
    torch.cuda.synchronize()
    ctx, bt = boot.ctx, boot.bootstrapper
    log(f"bootstrap set-up {time.time() - t0:.1f} s: "
        f"{json.dumps(boot.setup_s)} (seconds: context; key generation, "
        f"public + relinearization + {len(bt.galois_steps()) + 1} Galois "
        f"keys; Bootstrapper with its encoded diagonals; encryption); "
        f"L={ctx.L} K={ctx.K} dnum={ctx.dnum}, bootstrap levels "
        f"{bt.levels} (CoeffToSlot {len(bt.c2s_levels)}, EvalMod "
        f"{bt.mr.levels}, SlotToCoeff {len(bt.s2c_levels)}), diagonals per "
        f"level {[len(v) for v in bt.c2s_levels + bt.s2c_levels]}, arcsin "
        f"degree {bt.mr.arcsin_deg}; EvalMod cosine degree "
        f"{bt.mr.degree}, max error at the integer centres "
        f"{np.abs(bt.mr.centre_error()).max():.3e}, the most it can add "
        f"coherently to a slot {bt.coherent_error_bound():.3e}; x "
        f"{tuple(boot.x_data.shape)}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")

    kern = check_kernels(ctx)

    stages, mark = [], [0.0]

    def on_stage(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append((name, round(now - mark[0], 3)))
        mark[0] = now

    bt.on_stage = on_stage
    bt.encode_s = 0.0
    ntt_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    mark[0] = time.perf_counter()
    out, prof = profile_pass(lambda: boot.fn(boot.x_data))
    bt.on_stage = None
    secs = prof["wall_s"]
    launches = dict(ntt_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    log(f"bootstrap: {secs:.2f} s per pass of {BOOT_BATCH} ciphertexts, "
        f"{secs / BOOT_BATCH:.3f} s per ciphertext; by stage (s): "
        f"{json.dumps(stages)}; host encoding of diagonals in the pass "
        f"{bt.encode_s:.3f} s; device busy {prof['device_busy_s']:.2f} s "
        f"({100 * prof['device_busy_share']:.1f}%); peak "
        f"{peak / 2**30:.2f} GiB allocated, {peak_reserved / 2**30:.2f} GiB "
        f"reserved; output n_q={out.n_q}; launches {launches}")
    log("bootstrap profile:", json.dumps(prof))
    for k in KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{k} was not launched by the bootstrap")
        kern[k]["launches"] = launches[k]
    if out.n_q != ctx.L - 2 * bt.levels or out.n_q != boot.n_out:
        raise SystemExit(f"bootstrap output at {out.n_q} limbs, not "
                         f"{ctx.L - 2 * bt.levels}")
    check_modraise(boot)

    got = boot.decode(out)
    del out
    want = boot.values
    if got.shape != want.shape or not np.isfinite(got).all():
        raise SystemExit(f"bootstrap output {got.shape} not finite / not "
                         f"{want.shape}")
    err_re = float(np.abs(got.real - want).max())
    err_im = float(np.abs(got.imag).max())
    log(f"bootstrap vs its input over {want.size} slots: max |real - in| "
        f"{err_re:.3e}, max |imag| {err_im:.3e} (tolerance {BOOT_ATOL}); "
        f"per ciphertext real {np.abs(got.real - want).max(-1).tolist()}")
    if max(err_re, err_im) > BOOT_ATOL:
        raise SystemExit("bootstrap output outside tolerance")
    return kern


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


def run_head() -> dict:
    """The head phase: set-up, kernels against plain at its chain, one
    timed pass that must launch both kernels, the oracle check.  Returns
    the kernels' measurements with the pass's launches."""
    from moai_tpu_torch import ntt_cuda
    from moai_tpu_torch.entry import build_head
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
    return kern


def layer_stages(refresh_log, t0: float) -> list:
    """A layer's stretches between its refreshes, and the refreshes, in
    host seconds from its start t0 (time.perf_counter)."""
    stages, end = [], t0
    for label, (shape, n_q, start, dt) in zip(LAYER_STAGES, refresh_log):
        stages.append((label, round(start - end, 2)))
        stages.append((f"refresh {list(shape)} -> n_q {n_q}", round(dt, 2)))
        end = start + dt
    return stages


def run_layer() -> dict:
    """The layer phase: set-up, kernels against plain at its chain, one
    pass with the launch counts set to 0 just before, timed on the host
    clock and traced by torch.profiler, then the oracle check.  Returns the
    kernels' measurements with the pass's launches."""
    from moai_tpu_torch import ntt_cuda
    from moai_tpu_torch.entry import build_layer
    from moai_tpu_torch.models.bert import BertDims, DepthPlan
    t0 = time.time()
    layer = build_layer(**LAYER, dims=BertDims(**LAYER_DIMS),
                        plan=DepthPlan(**LAYER_PLAN), device="cuda")
    inner = layer.layer
    log(f"layer set-up {time.time() - t0:.1f} s: "
        f"{json.dumps(layer.setup_s)} (context, keys, weights, calibration;"
        f" encode + encrypt of the input); L={layer.ctx.L} K={layer.ctx.K}"
        f" n_att={inner.n_att} n_ln1={inner.n_ln1} n_ffn={inner.n_ffn}; "
        f"column chunks: LayerNorm/FFN {inner.col_chunk}, QK^T "
        f"{inner.attn.col_chunk}; x {tuple(layer.x_data.shape)}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    d = layer.domains
    log(f"calibration: max table {layer.max_val:.4f}, gelu domain "
        f"{d['gelu']:.4f}, LayerNorm S domains {d['ln1']} (hi/lo "
        f"{d['ln1'][1] / d['ln1'][0]:.2f}) and {d['ln2']} (hi/lo "
        f"{d['ln2'][1] / d['ln2'][0]:.2f}); the linear rsqrt init "
        f"diverges past hi/lo ~20")

    kern = check_kernels(layer.ctx)

    ntt_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, prof = profile_pass(lambda: layer.fn(layer.x_data))
    secs = prof["wall_s"]
    launches = dict(ntt_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    refresh_s = sum(r[3] for r in layer.refresh_log)
    n = LAYER["input_count"]
    stages = layer_stages(layer.refresh_log, t0)
    log(f"layer: {secs:.2f} s per pass, {secs / n:.4f} s per input; "
        f"inside the Recryptor refreshes {refresh_s:.2f} s, the rest "
        f"{secs - refresh_s:.2f} s; peak {peak / 2**30:.2f} GiB allocated, "
        f"{peak_reserved / 2**30:.2f} GiB reserved; output "
        f"n_q={out.n_q}; launches {launches}; by stage (s): "
        f"{json.dumps(stages)}")
    for k in KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{k} was not launched by the layer")
        kern[k]["launches"] = launches[k]

    got = layer.decode(out)
    del out
    want = layer.oracle()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise SystemExit(f"layer output {got.shape} not finite / not "
                         f"{want.shape}")
    err = float(np.abs(got - want).max())
    rows = np.arange(LAYER_DIMS["num_row"])[None, :] < layer.lens[:, None]
    err_plain = float(np.abs(got - layer.plain())[rows].max())
    log(f"layer vs float64 oracle: max |err| {err:.3e} (tolerance "
        f"{LAYER_ATOL}), max |out| {np.abs(want).max():.3f}; vs "
        f"plain_bert_layer (valid rows, not gated): {err_plain:.3e}")
    log("layer profile:", json.dumps(prof))
    if err > LAYER_ATOL:
        raise SystemExit("layer output outside tolerance")
    return kern


def checkpoint(model, ct, i: int) -> dict:
    """Layer i's output through serial and back: saved into a temporary
    directory, loaded onto the card and held torch.equal to the
    ciphertext in memory (gated), the file deleted.  Returns the save and
    load seconds, the file's bytes and the disk's free bytes before."""
    with tempfile.TemporaryDirectory() as d:
        free = shutil.disk_usage(d).free
        log(f"checkpoint of layer {i}: {free / 2**30:.1f} GiB free on the "
            f"disk of {d}")
        path = os.path.join(d, f"layer{i}.zip")
        t = time.perf_counter()
        model.save_state(path, ct, i)
        save_s = time.perf_counter() - t
        size = os.path.getsize(path)
        t = time.perf_counter()
        back, idx = model.load_state(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        same = (idx == i and back.scale == ct.scale
                and back.data.device == ct.data.device
                and torch.equal(back.data, ct.data))
        del back
        os.remove(path)
    if not same:
        raise SystemExit(f"layer {i}'s checkpoint, reloaded, differs from "
                         f"its ciphertext")
    return {"save_s": save_s, "load_s": load_s, "bytes": size,
            "disk_free_bytes": free}


def run_model() -> dict:
    """The model phase: the stacked encoder over MODEL_LAYERS layers.
    Set-up, kernels against plain at its chain, then one pass with the
    launch counts set to 0 just before: layer 0 with OpTrace on the
    evaluator and traced by torch.profiler, the later layers on the host
    clock; after each layer its checkpoint round trip and the oracle
    check (both gated).  Returns the kernels' measurements with the
    pass's launches, less those of the checks between layers."""
    from torch.profiler import ProfilerActivity, profile
    from moai_tpu_torch import ntt_cuda
    from moai_tpu_torch.entry import build_model
    from moai_tpu_torch.models.bert import (BertDims, DepthPlan,
                                            plain_bert_layer)
    from moai_tpu_torch.utils.debug import OpTrace
    t0 = time.time()
    model = build_model(**LAYER, dims=BertDims(**LAYER_DIMS),
                        plan=DepthPlan(**LAYER_PLAN), n_layers=MODEL_LAYERS,
                        device="cuda")
    first = model.model.layers[0]
    log(f"model set-up {time.time() - t0:.1f} s: "
        f"{json.dumps(model.setup_s)} (context, keys, weights of "
        f"{MODEL_LAYERS} layers, calibration; encode + encrypt of the "
        f"input); L={model.ctx.L} K={model.ctx.K} n_att={first.n_att} "
        f"n_ln1={first.n_ln1} n_ffn={first.n_ffn}; column chunks: "
        f"LayerNorm/FFN {first.col_chunk}, QK^T {first.attn.col_chunk}; x "
        f"{tuple(model.x_data.shape)}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    for i, (m, d) in enumerate(zip(model.max_table, model.domains)):
        ln1, ln2 = ([round(float(v), 3) for v in d[k]] for k in ("ln1",
                                                                 "ln2"))
        log(f"calibration, layer {i}: max table {m:.4f}, gelu domain "
            f"{d['gelu']:.4f}, LayerNorm S domains {ln1} (hi/lo "
            f"{ln1[1] / ln1[0]:.2f}) and {ln2} (hi/lo {ln2[1] / ln2[0]:.2f})")

    kern = check_kernels(model.ctx)

    ev, n_ref = first.ev, len(LAYER_STAGES)
    trace = OpTrace()
    prof = profile(activities=[ProfilerActivity.CUDA])
    check_launches = dict.fromkeys(KERNELS, 0)
    plain_in = [model.xs]
    mark = [0.0]

    def on_layer(i, ct):
        torch.cuda.synchronize()
        secs = time.perf_counter() - mark[0]
        rec = {"s": secs,
               "refresh_s": sum(r[3] for r in model.refresh_log[
                   n_ref * i:n_ref * (i + 1)]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
        prof_rec = None
        if i == 0:
            ev.debug = None
            prof.stop()
            rec["stages"] = layer_stages(model.refresh_log[:n_ref], mark[0])
            prof_rec = profile_summary(prof, secs)
        before = dict(ntt_cuda.launches)
        torch.cuda.reset_peak_memory_stats()
        rec.update(checkpoint(model, ct, i))
        rec["checkpoint_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        got = model.decode(ct)
        want = model.oracle(i + 1)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise SystemExit(f"layer {i} output {got.shape} not finite / "
                             f"not {want.shape}")
        rec["err"] = float(np.abs(got - want).max())
        rec["max_out"] = float(np.abs(want).max())
        plain = np.zeros_like(got)
        for j, n in enumerate(model.lens):
            plain[j, :n] = plain_bert_layer(plain_in[0][j, :n],
                                            model.weights[i], model.dims)
        plain_in[0] = plain
        rows = np.arange(model.dims.num_row)[None, :] < model.lens[:, None]
        rec["err_plain"] = float(np.abs(got - plain)[rows].max())
        for k in KERNELS:
            check_launches[k] += ntt_cuda.launches[k] - before[k]
        log(f"model layer {i}: {json.dumps(rec)}")
        if prof_rec is not None:
            log(f"model layer {i} profile:", json.dumps(prof_rec))
        if rec["err"] > LAYER_ATOL:
            raise SystemExit(f"layer {i} output outside tolerance")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        mark[0] = time.perf_counter()

    ntt_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ev.debug = trace
    prof.start()
    torch.cuda.synchronize()
    t1 = mark[0] = time.perf_counter()
    try:
        out = model.fn(model.x_data, on_layer=on_layer)
    finally:
        ev.debug = None
    secs = time.perf_counter() - t1
    launches = {k: ntt_cuda.launches[k] - check_launches[k]
                for k in KERNELS}
    log(f"model: {MODEL_LAYERS} layers and their checks in {secs:.2f} s; "
        f"output n_q={out.n_q}; launches in the layers {launches}, in the "
        f"checks between them (not counted) {check_launches}; OpTrace of "
        f"layer 0: {len(trace.events)} ops {json.dumps(trace.summary())}, "
        f"lowest n_q {trace.min_n_q()}")
    for k in KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"{k} was not launched by the model")
        kern[k]["launches"] = launches[k]
    if out.n_q != first.n_att:
        raise SystemExit(f"model output at {out.n_q} limbs, not "
                         f"{first.n_att}")
    return kern


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from moai_tpu_torch import ntt_cuda

    t0 = time.time()
    lib, msgs = ntt_cuda.build()
    log(f"built {lib.name} in {time.time() - t0:.1f} s")
    for line in msgs.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log("  nvcc:", line.strip())
    name_power = card()
    log(f"card: {name_power}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    phases = {"bootstrap": run_bootstrap, "head": run_head,
              "model": run_model, "layer": run_layer}
    chosen = sys.argv[1:] or ["bootstrap", "head", "model"]
    unknown = set(chosen) - set(phases)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    paths = {}
    for name in chosen:
        paths[name] = phases[name]()
        gc.collect()
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": "moai_tpu_torch/csrc/ntt.cu",
         "replaces": KERNELS[k], "launches": m[k]["launches"],
         "max_abs_err": m[k]["max_abs_err"], "ms": m[k]["ms"],
         "plain_ms": m[k]["plain_ms"], "bound_ms": m[k]["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "path": path,
         "shape": m[k]["shape"], "device_ms": m[k]["device_ms"]}
        for path, m in paths.items() for k in KERNELS]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
