"""Smoke run of moai_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [bootstrap] [head] [shard] [model] [layer] [kernels]

With no argument it runs bootstrap, head, shard and model, in this order;
naming phases runs only those (``layer`` runs only when named: the model's layer
0 is the same layer on the same input, and reports the same numbers;
``kernels``, only when named, times the limb kernels alone on the three
chains, and with MOAI_LIMB_SOURCE naming another limb.cu builds them from
that file, so two versions compare in one call).

1. Builds the kernels (moai_tpu_torch/csrc/ntt.cu and csrc/limb.cu) with
   nvcc for sm_90a, one nvcc per source, in parallel; prints each
   kernel's registers and spills and the SASS instruction mix of the limb
   kernels (cuobjdump), and reads the card's maximum SM clock for the
   integer bound.
2. bootstrap: at N=2^16 on flagship_config (entry.build_bootstrap: 32768
   slots, L 74 = q0 pair + 20 data pairs + 16 boot pairs, K 13, dnum 6,
   Galois keys for every CoeffToSlot/SlotToCoeff step and the
   conjugation; every residue int32, as everywhere in the port): set-up
   seconds (context, key generation, the Bootstrapper with its encoded
   diagonals, encryption); then holds each
   kernel against its plain PyTorch version over all 87 limbs of this
   context and on limb slices (torch.equal), and times both at [8, 2, 87,
   2^16] beside the memory bound (one call per CUDA-event pair, and the
   device time per call of each of its two kernels from torch.profiler);
   holds each limb kernel torch.equal to its plain version at this
   chain's shapes (check_limb_kernels) and times both the same way;
   then one pass of make_refresh over BOOT_BATCH ciphertexts of U(-0.8,
   0.8) slot values, each its own, from n_q0 + 2 limbs to the 42-limb data
   chain, with the launch counts set to 0 just before (every kernel must
   have launched: both NTT kernels and the four limb kernels; the output
   must hold int32 residues): seconds
   per pass, per ciphertext and per stage (ModRaise,
   each CoeffToSlot level, EvalMod real and imaginary, each SlotToCoeff
   level, the card synchronized between stages), the device's busy share
   and top kernels (torch.profiler), peak memory; then the decrypted
   slots against the input (gated, real and imaginary parts), and ModRaise
   on the first ciphertext against the plain path on the CPU (reported).
3. head: the encrypted attention head at BERT-base head width (d_model
   768, head_dim 64, 128 tokens, 128 interleaved inputs, logN 15, L 34)
   with weights drawn at BERT-base magnitude: after set-up, the same check
   and timing on its context (all 45 limbs and slices, [8, 2, 45, 2^15];
   the limb kernels but diag_mac); then one pass with the launch counts
   set to 0 just before (the NTT kernels, limb_ew, base_conv and ks_mac
   must have launched), decrypted and compared with the float64 oracle.
4. shard: the sharded programs (moai_tpu_torch/parallel/sharding.py) on
   virtual meshes of cuda:0 (mesh positions time-sharing the card), on the
   bootstrap's and the head's contexts and keys (kept from those phases;
   built here when they did not run): make_refresh over BOOT_BATCH
   ciphertexts at flagship_config over a (2, 1) mesh (one ciphertext per
   position) and over (1, 2) (the limbs split: 37 of the 74 per
   position, each with its rows of the 107 Galois keys); ccmm_col_to_diag
   at the head's width (64 columns of its input, num_row 128, logN 15)
   over (2, 1) and, limbs split, (1, 2); the evaluator step of
   tools/scaling_sweep.py (multiply, relinearize, rescale twice, rotate
   by 1) on the bootstrap's output (42 limbs) over (1, 2) and (2, 2),
   limbs split; then, the bootstrap's objects freed, the head phase's
   whole head (entry.shard_head, the port of __graft_entry__.
   dryrun_multichip: nothing of its width cut) over (2, 1) (the input's
   columns split) and (1, 2) and (2, 2) (the input at P("col", None,
   "limb", None)).  A mesh whose limb axis is 1 splits the columns only.
   Each runs unsharded and then sharded on the same input, the launch
   counts set to 0 and the peak counters reset before each: the gathered
   output is held torch.equal to the unsharded one (gated), every kernel
   the unsharded run launched must have launched in the sharded one
   (gated), a sharded bootstrap may peak on no card above
   SHARD_BOOT_PEAK_RATIO times the unsharded run's peak (gated), and a
   sharded head on one card not above the unsharded head's peak plus
   the bytes its placement copied plus SHARD_HEAD_PEAK, nor keeping more
   than SHARD_HEAD_KEPT allocated after it (both gated); the seconds of
   both, the memory held before, kept after and the peak of both runs on
   each card of the mesh (for the head, also its own peak above the
   memory held), and the bytes moved between mesh positions
   (sharding.moved) and those of them copied (sharding.copied).  With more than
   one card the same programs run again on meshes of real cards
   (per-card peak); on a one-card host that run is reported as not
   possible.  Then every kernel is held torch.equal to its plain version
   and timed at a limb shard's window of the bootstrap's chain (the
   (1, 2) mesh's second position after ModRaise: its Q limbs [37, 74),
   its special limbs [6, 13), its key rows read in place from row 37 of
   whole keys), and base_conv and ks_mac again at the sharded runs'
   commonest launch shapes at N = 2^16 (path "shard"); and the same at
   the head's chain (Q [17, 34), special [5, 11), the head's sharded
   runs' launches and launch shapes; path "shard_head", without
   diag_mac).
5. model: the stacked encoder at full BERT-base width, MODEL_LAYERS of its
   12 layers (entry.build_model: d_model 768, 12 heads of 64, d_inter 3072,
   128 tokens, 128 inputs, logN 15, L 28, DepthPlan(5, 5, 2, 0, 16),
   weights synthesized by load_reference_layer, domains from one
   calibrate_domains over every layer, the harness Recryptor as its
   refresh): set-up seconds, the same kernel check and timing on its
   context (all 38 limbs and slices, [8, 2, 38, 2^15]), then one pass with
   the launch counts set to 0 just before (the kernels the head needs must
   have launched).  Layer 0 runs with utils.debug.OpTrace on the evaluator
   and under torch.profiler (device time by kernel and the busy share), the
   later layers on the host clock; each layer's seconds, the seconds inside
   its refreshes, its peak memory (layer 0: by stage). After each layer
   (EncryptedBertModel's on_layer): its state saved with
   serial.save_layer_state into a temporary directory, loaded back onto the
   card and held torch.equal to the ciphertext in memory (gated), save and
   load seconds and the file's bytes (the ciphertext handed to on_layer
   and the one loaded back must hold int32); then the decrypted output
   against the chained float64 oracle (Model.oracle, gated at
   LAYER_ATOL) and against plain_bert_layer chained (reported).  The launches of these checks are
   not counted as the path's.  Ends with the OpTrace summary of layer 0: op
   counts and the lowest n_q.
6. layer (only when named): one encoder layer at the same width and chain
   (entry.build_layer): set-up, the same kernel check, one pass traced by
   torch.profiler, its seconds, peak memory and refresh seconds, the
   decrypted output against the float64 oracle (gated) and against
   plain_bert_layer (reported).

After each path's pass, base_conv and ks_mac are held torch.equal and
timed again at the pass's commonest launch shape (limb_cuda.shapes), and
ks_mac at its commonest hoisted shape through real Galois permutations
("main" and "hoisted" in their rows).

Prints a {"kernels": [...]} line, one row per kernel and path (diag_mac
on the bootstrap and shard only): each row's check and timings come from
that path's context (the shard paths': the windows above) and its
launches from that path's run (the shard paths': all their sharded runs);
the limb kernels'
bound is the larger of the byte bound (the tensors' own element sizes:
4-byte residues) and the integer bound (``bound_by``), the NTT's the
byte bound; then the card's
name and power limit, and as its last line {"ok": true, "device":
{...}}.  Exits non-zero, printing no result,
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
# The integer bound of the limb kernels: INT32 issue slots over the
# card's INT32 rate, 64 lanes per SM per clock (NVIDIA H100 Tensor Core GPU
# Architecture white paper) x the SMs x the card's maximum SM clock
# (nvidia-smi clocks.max.sm, read at the start).  The slots each step
# needs at least, as the kernels' SASS issues them (cuobjdump -sass, its
# instruction mix printed at the start): a 32x32 -> 64-bit multiply-add is
# one IMAD.WIDE.U32, two slots; base_conv's two-step reduction of a 64-bit
# sum (two IMAD, two IMAD.WIDE.U32, a 64-bit add, the canonical subtract)
# ten; one REDC of a group of products with its canonical add (ks_mac,
# diag_mac) eight; the conversion of an input (a product and one REDC)
# seven; limb_ew's Montgomery product of one element (the product, one
# REDC, the canonical subtract and the range check) eight.
INT32_LANES_PER_SM = 64
SLOTS_PER_PRODUCT = 2
SLOTS_PER_REDC2 = 10
SLOTS_PER_GROUP_REDC = 8
SLOTS_PER_CONVERT = 7
SLOTS_PER_EW_MUL = 8
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
# Each kernel: what it replaces in the JAX package (a Pallas kernel, or
# jnp code that XLA fuses) and its source.
NTT_SRC, LIMB_SRC = "moai_tpu_torch/csrc/ntt.cu", "moai_tpu_torch/csrc/limb.cu"
KERNELS = {
    "ntt_fwd": ("moai_tpu/pallas_ntt.py:282", NTT_SRC),
    "ntt_inv": ("moai_tpu/pallas_ntt.py:301", NTT_SRC),
    "limb_ew": ("moai_tpu/mod_arith.py:96 (jnp mont_mul; to_mont :124, "
                "from_mont :129, add/sub/neg_mod :151-161)", LIMB_SRC),
    "base_conv": ("moai_tpu/evaluator.py:248 (jnp base extension of "
                  "_ks_decompose; _mod_down_p :340, boot/bootstrap.py:124 "
                  "modraise)", LIMB_SRC),
    "ks_mac": ("moai_tpu/evaluator.py:307 (jnp digit MAC of "
               "_ks_mac_moddown; rotate_hoisted :456)", LIMB_SRC),
    "diag_mac": ("moai_tpu/boot/linear.py:59 (jnp multiply_plain + add_mod "
                 "sum of apply_diagonals)", LIMB_SRC),
}
# The commonest launch shapes of base_conv, ks_mac and hoisted ks_mac in
# each path's pass (limb_cuda.conv_shape and mac_shape; from the default
# run's "launch shapes" lines), which the kernels phase times without
# running the paths.
MAIN_SHAPES = {
    "bootstrap": ((2, 13, 1, 13, 72, 65536, True, False),
                  (1, 2, 6, 85, 65536, 87, 74, False),
                  (2, 2, 6, 87, 65536, 87, 74, True)),
    "head": ((64, 11, 1, 11, 4, 32768, True, False),
             (1, 64, 1, 15, 32768, 45, 34, False),
             (4, 11, 3, 43, 32768, 45, 34, True)),
    "model": ((64, 10, 1, 10, 8, 32768, True, False),
              (1, 64, 1, 18, 32768, 38, 28, False),
              (4, 13, 3, 36, 32768, 38, 28, True)),
}
# The kernels each path must launch: diag_mac serves the bootstrap's linear
# transforms only.
PATH_KERNELS = {"bootstrap": list(KERNELS), "shard": list(KERNELS),
                "head": [k for k in KERNELS if k != "diag_mac"],
                "shard_head": [k for k in KERNELS if k != "diag_mac"],
                "model": [k for k in KERNELS if k != "diag_mac"],
                "layer": [k for k in KERNELS if k != "diag_mac"]}


# The shard phase: the (col, limb) shapes of its virtual meshes on cuda:0,
# by program; the CCMM's columns (of the head's 768-column input).
SHARD_MESHES = {"bootstrap": [(2, 1), (1, 2)], "ccmm": [(2, 1), (1, 2)],
                "step": [(1, 2), (2, 2)], "head": [(2, 1), (1, 2), (2, 2)]}
SHARD_CCMM_COLUMNS = 64
# The most a sharded bootstrap may peak at on any card, as a multiple of
# the unsharded run's peak on the same card just before: a limb shard reads
# its key rows in place where the keys lie, so a mesh adds only its
# all-gathered and per-position buffers, and never a copy of the keys
# (29.3 GB at flagship_config).
SHARD_BOOT_PEAK_RATIO = 1.1
# The most the sharded head may peak at on one card above the unsharded
# head's peak and the bytes its placement copied (a limb shard of the
# input is a strided slice; a column shard is a view), in GiB: its
# per-position partials and buffers.
SHARD_HEAD_PEAK = 1.0
# The most the sharded head on one card may leave allocated after its run
# (its output freed) above what the card held before it, in GiB.  A
# virtual mesh keeps nothing of its own (a replica on the keys' card is
# the object itself, key rows are read in place), so a kept copy of the
# head's 32 keys (1.05 GiB) fails.  The peak gate cannot see one: the
# sharded head peaks below the unsharded one.
SHARD_HEAD_KEPT = 0.25

START = time.time()
INT32_OPS_PER_S = [0.0]         # set in main from the card
# what the bootstrap and head phases leave for the shard phase when it is
# to run ("keep"): their Bootstrap and Head, the bootstrap's measurements
SHARED = {"keep": False}


def log(*a):
    """Print a line, prefixed with the seconds since the script started."""
    print(f"[{time.time() - START:7.1f} s]", *a, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """The card's INT32 rate: lanes per SM x SMs x the maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def sass_mix(lib) -> dict:
    """The instruction mix of each instantiation of the limb kernels in
    the built library (cuobjdump -sass): {function: {opcode: count}}, or
    {} where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    mix, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            cur = None
            for k in ("limb_ew", "base_conv", "ks_mac", "diag_mac"):
                if k in name:
                    cur = mix.setdefault(f"{k}<{name.split('ILi')[1].split('E')[0]}>"
                                         if "ILi" in name else name, {})
        elif cur is not None and "/*" in line and ";" in line:
            ins = line.split("*/", 1)[1].split(";")[0].split()
            if ins and ins[0].startswith("@"):
                ins = ins[1:]
            if ins:
                cur[ins[0]] = cur.get(ins[0], 0) + 1
    return mix


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
    """Device time per launch of each CUDA kernel that fn() launches (each
    once per call), from torch.profiler over ``calls`` calls.  The tracer
    may drop some kernels' records, so each time is divided by the
    launches it recorded, and a trace that recorded none is taken again
    (at most three times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {kernel_name(e.key): e.self_device_time_total / 1e3 / e.count
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total}
        if out:
            return out
    return out


def launch_counts() -> dict:
    from moai_tpu_torch import limb_cuda, ntt_cuda
    return {**ntt_cuda.launches, **limb_cuda.launches}


def launch_shapes() -> dict:
    """A copy of limb_cuda.shapes: base_conv's and ks_mac's launches by
    launch shape since the counts were last set to 0."""
    from moai_tpu_torch import limb_cuda
    return {k: dict(v) for k, v in limb_cuda.shapes.items()}


def reset_launches() -> None:
    from moai_tpu_torch import limb_cuda, ntt_cuda
    ntt_cuda.reset_launches()
    limb_cuda.reset_launches()


def require_launches(path: str, launches: dict, kern: dict) -> None:
    """Each kernel of ``path`` launched in its pass; records the counts."""
    for k in PATH_KERNELS[path]:
        if launches[k] <= 0:
            raise SystemExit(f"{k} was not launched by the {path}")
        kern[k]["launches"] = launches[k]


def require_int32(what: str, t: torch.Tensor) -> None:
    """The port's residues are int32 at rest: fail on any other dtype."""
    if t.dtype != torch.int32:
        raise SystemExit(f"{what} holds {t.dtype} residues, not int32")


def random_residues(qs: torch.Tensor, lead: tuple, N: int) -> torch.Tensor:
    """Uniform int32 residues [*lead, len(qs), N], row l below qs[l], on
    the card."""
    r = torch.randint(0, 1 << 62, lead + (len(qs), N), dtype=torch.int64,
                      device=qs.device)
    return r.remainder_(qs.reshape(-1, 1)).to(torch.int32)


def check_kernels(ctx, path: str, window=None) -> dict:
    """Kernels vs plain on the card at this path's context; returns the
    per-kernel measurements.  With ``window`` (lo, hi, plo, phi), a limb
    shard's: the NTT on its Q limbs [lo, hi) and its special limbs
    [plo, phi), timed on the former, and check_limb_kernels at the
    window."""
    from moai_tpu_torch import ntt as nt
    from moai_tpu_torch import ntt_cuda
    tb = ctx.dev["ntt"]
    cuda_tb = tb["cuda"]
    L, nall, N = ctx.L, ctx.L + ctx.K, ctx.cfg.N
    torch.manual_seed(0)
    x = random_residues(tb["q"], (8, 2), N)          # 8 ciphertexts, Q+P
    if window is None:
        cases = [((0, nall), x), ((L, nall), x[..., L:, :]),
                 ((5, 17), x[0, :, 5:17, :].contiguous())]
        span = None
    else:
        lo, hi, plo, phi = window
        span = (lo, hi)
        cases = [(span, x[..., lo:hi, :]),
                 ((L + plo, L + phi), x[..., L + plo:L + phi, :])]
        x = x[..., lo:hi, :].contiguous()
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
        ms = time_ms(lambda: kern(x, cuda_tb, span))
        dev = device_ms(lambda: kern(x, cuda_tb, span))
        plain_ms = time_ms(lambda: plain(x, tb, span), reps=3)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, shape=list(x.shape), device_ms=dev)
        log(f"{name} N=2^{ctx.cfg.logN}: equal to plain on limbs "
            f"{[c[0] for c in cases]}; {tuple(x.shape)}: kernel {ms:.3f} ms, "
            f"device {json.dumps(dev)}, plain {plain_ms:.3f} ms, memory "
            f"bound {bound:.3f} ms")
    fwd = ntt_cuda.ntt_cuda(x, cuda_tb, span)
    if not torch.equal(ntt_cuda.intt_cuda(fwd, cuda_tb, span), x):
        raise SystemExit("intt(ntt(x)) != x on the card")
    log("round trip intt(ntt(x)) == x")
    del x, fwd
    res.update(check_limb_kernels(ctx, path, window))
    return res


def measure(name: str, pairs, kern, plain, nbytes: int, shape,
            slots: int | None = None) -> dict:
    """Hold each (kernel call, plain call) of ``pairs`` torch.equal (every
    tensor of a tuple result), then time ``kern`` and ``plain`` as
    check_kernels times the NTT, beside the bound: the larger of the byte
    bound and, given the INT32 issue slots the call needs at least, the
    integer bound."""
    err = 0
    for i, (got_fn, want_fn) in enumerate(pairs):
        got, want = got_fn(), want_fn()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g - w).abs().max()) if g.shape == w.shape
                      else 1 << 62)
            if not torch.equal(g, w):
                raise SystemExit(f"{name} differs from its plain version in "
                                 f"case {i}: max |diff| {err}")
        del got, want
    ms = time_ms(kern)
    dev = device_ms(kern)
    plain_ms = time_ms(plain, reps=3)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = None if slots is None else slots / INT32_OPS_PER_S[0] * 1e3
    bound, bound_by = (by_bytes, "bytes") if by_ops is None \
        or by_ops <= by_bytes else (by_ops, "operations")
    log(f"{name}: equal to plain in {len(pairs)} cases; {shape}: kernel "
        f"{ms:.4f} ms, device {json.dumps(dev)}, plain {plain_ms:.4f} ms, "
        f"byte bound {by_bytes:.5f} ms, integer bound "
        f"{'-' if by_ops is None else f'{by_ops:.5f}'} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, bound_bytes_ms=by_bytes,
                bound_ops_ms=by_ops, shape=list(shape), device_ms=dev)


def galois_perms(N: int, steps, device) -> torch.Tensor:
    """NTT-domain permutations of the slot rotations by ``steps``, as the
    Galois keys hold them (keys.KeyGenerator.galois_perm of 5^s mod 2N)."""
    k = torch.arange(N, device=device)
    return torch.stack([((pow(5, s, 2 * N) * (2 * k + 1)) % (2 * N) - 1) // 2
                        for s in steps])


def conv_cost(shape, elt: int) -> tuple:
    """base_conv's bytes (each input read once, each output written once,
    ``elt`` bytes a residue), shape and least INT32 issue slots, from its
    launch shape (limb_cuda.conv_shape): products, one two-step reduction
    per sum of up to 16 products, the input conversions, ModRaise's k
    term."""
    B, S, D, A, T, N, hatinv, k = shape
    cnts = [min(A, S - d * A) for d in range(D)]
    slots = B * N * T * (SLOTS_PER_PRODUCT * sum(cnts) + SLOTS_PER_REDC2
                         * sum(-(-c // 16) for c in cnts))
    slots += SLOTS_PER_CONVERT * B * S * N if hatinv else 0
    slots += SLOTS_PER_GROUP_REDC * B * D * T * N if k else 0
    return elt * B * N * (S + D * T + (1 if k else 0)), shape, slots


def mac_cost(shape, elt: int) -> tuple:
    """ks_mac's bytes (``elt`` bytes a residue of y, the keys and the
    output; 8 a permutation entry), shape and least INT32 issue slots from
    its launch shape (limb_cuda.mac_shape): each output a sum of D
    products, REDC'd in groups of four."""
    R, B, D, T, N, KL, q_limbs, with_perm = shape
    outs = 2 * R * B * T * N
    nbytes = (elt * (B * D * T * N + R * D * 2 * T * N + outs)
              + (8 * R * N if with_perm else 0))
    return nbytes, shape, outs * (SLOTS_PER_PRODUCT * D
                                  + SLOTS_PER_GROUP_REDC * -(-D // 4))


def conv_inputs(ctx, shape):
    """Uniform inputs of base_conv's launch shape on the card, over this
    context's primes: (kernel call, plain call)."""
    from moai_tpu_torch import mod_arith as ma
    B, S, D, A, T, N, with_hatinv, with_k = shape
    dv = ctx.dev
    primes, rinv = dv["q"], dv["rinv"]
    pad = torch.arange(D * A, device=primes.device) % S
    tq, rt = primes[:T].reshape(-1, 1), rinv[:T].reshape(-1, 1)
    x = random_residues(primes[:S], (B,), N)
    hat = random_residues(tq.reshape(-1), (D, A), 1)[..., 0]
    if with_hatinv:
        src = (primes[pad], rinv[pad],
               random_residues(primes[pad], (), 1)[..., 0])
    else:
        src = (None, None, None)
    k = kq = None
    if with_k:
        k = torch.randint(0, A + 1, (B, N), dtype=torch.int32,
                          device=x.device)
        kq = random_residues(tq.reshape(-1), (), 1)[..., 0]
    args = (x, *src, hat, tq, rt, k, kq)
    return (lambda: ma.base_conv(*args), lambda: ma.base_conv_plain(*args),
            x.element_size())


def mac_inputs(ctx, shape):
    """Uniform inputs of ks_mac's launch shape on the card, over this
    context's primes, with the Galois permutations of the rotations by
    1..R where the launch had a permutation: (kernel call, plain call,
    bytes of a residue)."""
    from moai_tpu_torch import mod_arith as ma
    R, B, D, T, N, KL, q_limbs, with_perm = shape
    dv, L = ctx.dev, ctx.L
    limbs = torch.cat([dv["q"][:q_limbs], dv["q"][L:L + KL - q_limbs]])
    lrinv = torch.cat([dv["rinv"][:q_limbs], dv["rinv"][L:L + KL - q_limbs]])
    n_q = T - (KL - q_limbs)
    tq = torch.cat([limbs[:n_q], limbs[q_limbs:]]).reshape(-1, 1)
    rt = torch.cat([lrinv[:n_q], lrinv[q_limbs:]]).reshape(-1, 1)
    y = random_residues(tq.reshape(-1), (B, D), N)
    keys = [random_residues(limbs, (D, 2), N) for _ in range(R)]
    if not with_perm:
        return (lambda: ma.ks_mac(y, keys[0], q_limbs, tq, rt),
                lambda: ma.ks_mac_plain(y, keys[0], q_limbs, tq, rt),
                y.element_size())
    perm = galois_perms(N, range(1, R + 1), y.device)
    return (lambda: ma.ks_mac(y, keys, q_limbs, tq, rt, perm),
            lambda: ma.ks_mac_plain(y, keys, q_limbs, tq, rt, perm),
            y.element_size())


def time_main_shapes(ctx, kern: dict, shapes: dict) -> None:
    """base_conv and ks_mac at the commonest launch shape of the path's
    pass (``shapes``: limb_cuda.shapes just after it), and ks_mac at the
    commonest shape of its hoisted launches (through real Galois
    permutations), each held torch.equal to its plain version and timed
    as check_limb_kernels times them; recorded under "main" and
    "hoisted"."""
    for name, key, pick, build, cost in (
            ("base_conv", "main", None, conv_inputs, conv_cost),
            ("ks_mac", "main", None, mac_inputs, mac_cost),
            ("ks_mac", "hoisted", lambda s: s[-1], mac_inputs, mac_cost)):
        counts = {s: n for s, n in shapes[name].items()
                  if pick is None or pick(s)}
        if not counts:
            continue
        top = sorted(counts.items(), key=lambda kv: -kv[1])
        log(f"{name} launch shapes{' (hoisted)' if pick else ''}: "
            f"{len(counts)} distinct, {sum(counts.values())} launches; the "
            f"commonest {[[list(s), n] for s, n in top[:5]]}")
        shape, n = top[0]
        kern_fn, plain_fn, elt = build(ctx, shape)
        m = measure(f"{name} at the pass's commonest {key} shape",
                    [(kern_fn, plain_fn)], kern_fn, plain_fn,
                    *cost(shape, elt))
        kern[name][key] = dict(m, launches_at_shape=n,
                               distinct_shapes=len(counts))
        del kern_fn, plain_fn
        gc.collect()
        torch.cuda.empty_cache()


def check_limb_kernels(ctx, path: str, window=None) -> dict:
    """The limb kernels against their plain versions on the card, at this
    path's chain: ciphertexts [B, 2, L, N] (B = BOOT_BATCH on the
    bootstrap and shard paths, else 8, as the NTT check), the key-switch
    decomposition of their c1 at the top level and at a level with a
    partial digit, the mod-down, ModRaise's conversion, the MAC with and
    without the hoisted permutation, and (bootstrap, shard) a giant step
    of 8 diagonals, the most lt_group 5 gives; every residue int32.  Each
    timed at its main case.  With ``window`` (lo, hi, plo, phi), a limb
    shard's: the ciphertexts hold Q limbs [lo, hi), each conversion
    targets those and the special limbs [plo, phi), and the MAC reads its
    key rows in place, from row lo of whole keys (as ShardedEvaluator
    does)."""
    from moai_tpu_torch import limb_cuda
    from moai_tpu_torch import mod_arith as ma
    dv, L, K, N = ctx.dev, ctx.L, ctx.K, ctx.cfg.N
    lo, hi, plo, phi = window or (0, L, 0, K)
    boot = path in ("bootstrap", "shard")
    B = BOOT_BATCH if boot else 8
    torch.manual_seed(1)
    qall = dv["q"]
    q, rinv = qall[lo:hi].reshape(-1, 1), dv["rinv"][lo:hi].reshape(-1, 1)
    a, b = (random_residues(qall[lo:hi], (B, 2), N) for _ in range(2))
    col = random_residues(qall[lo:hi], (B, 1), 1)
    u = torch.randint(0, 1 << 30, (B, 1, N), dtype=torch.int32,
                      device=a.device)
    r2 = dv["r2"][lo:hi].reshape(-1, 1)
    res = {}
    res["limb_ew"] = measure("limb_ew", [
        (lambda: ma.add_mod(a, b, q), lambda: ma.add_mod_plain(a, b, q)),
        (lambda: ma.sub_mod(a, b, q), lambda: ma.sub_mod_plain(a, b, q)),
        (lambda: ma.neg_mod(a, q), lambda: ma.neg_mod_plain(a, q)),
        (lambda: ma.mont_mul(a, b, q, rinv),
         lambda: ma.mont_mul_plain(a, b, q, rinv)),
        (lambda: ma.mont_mul(a, col, q, rinv),
         lambda: ma.mont_mul_plain(a, col, q, rinv)),
        (lambda: ma.to_mont(u, q, rinv, r2),
         lambda: ma.mont_mul_plain(u, r2, q, rinv)),
        (lambda: ma.from_mont(a, q, rinv),
         lambda: ma.from_mont_plain(a, q, rinv)),
        (lambda: ma.sub_mont_mul(a, b, col, q, rinv),
         lambda: ma.sub_mont_mul_plain(a, b, col, q, rinv))],
        lambda: ma.mont_mul(a, b, q, rinv),
        lambda: ma.mont_mul_plain(a, b, q, rinv),
        3 * a.numel() * a.element_size(), tuple(a.shape),
        a.numel() * SLOTS_PER_EW_MUL)

    # the decomposition reads all the level's limbs; a window's ciphertexts
    # hold some of them
    c1 = a[:, 1] if window is None else random_residues(qall[:L], (B,), N)

    def ks_args(n_q):
        D = sum(1 for d, _ in ctx.digit_ranges if d < n_q)
        top = min(hi, n_q)
        qt = torch.cat([qall[lo:top], qall[L + plo:L + phi]]).reshape(-1, 1)
        rt = torch.cat([dv["rinv"][lo:top],
                        dv["rinv"][L + plo:L + phi]]).reshape(-1, 1)
        hat = dv["ks_hat_mm"][n_q, :D]
        hat_t = torch.cat([hat[..., lo:top], hat[..., L + plo:L + phi]],
                          dim=-1)
        return D, qt, rt, (c1[:, :n_q].contiguous(), dv["ks_q_pad"],
                           dv["ks_rinv_pad"], dv["ks_hatinv_mont"][n_q, :D],
                           hat_t, qt, rt)
    D, qt, rt, top = ks_args(L)
    _, _, _, mid = ks_args(L - ctx.alpha // 2 - 1)
    n0 = ctx.n_q0
    lam = a[:, :, :n0].contiguous() if window is None else \
        random_residues(qall[:n0], (B, 2), N)
    k = torch.randint(0, n0 + 1, (B, 2, N), dtype=torch.int32,
                      device=a.device)
    modraise = (lam, None, None, None,
                random_residues(qall[lo:hi], (1, n0), 1)[..., 0], q, rinv, k,
                dv["r1"][lo:hi])
    cp = random_residues(qall[L:], (B, 2), N)
    moddown = (cp, qall[L:], dv["rinv"][L:], dv["pdown_hatinv_mont"],
               dv["pdown_hat_modq_mm"][None, :, lo:hi], q, rinv)
    cases = (top, mid, moddown, modraise)
    res["base_conv"] = measure("base_conv", [
        (lambda c=c: ma.base_conv(*c), lambda c=c: ma.base_conv_plain(*c))
        for c in cases],
        lambda: ma.base_conv(*top), lambda: ma.base_conv_plain(*top),
        *conv_cost(limb_cuda.conv_shape(top[0], top[4], top[3], None),
                   top[0].element_size()))
    del mid, modraise, moddown, cp, lam, cases

    y = random_residues(qt.reshape(-1), (B, D), N)
    keys = [random_residues(qall, (ctx.dnum, 2), N)[..., lo:L + phi, :]
            for _ in range(3)]
    ql = L + plo - lo                   # the window's row of special limb plo
    perm = galois_perms(N, (1, 2, 3), a.device)
    key = keys[0]
    res["ks_mac"] = measure(
        "ks_mac", [(lambda: ma.ks_mac(y, key, ql, qt, rt),
                    lambda: ma.ks_mac_plain(y, key, ql, qt, rt)),
                   (lambda: ma.ks_mac(y, keys, ql, qt, rt, perm),
                    lambda: ma.ks_mac_plain(y, keys, ql, qt, rt, perm))],
        lambda: ma.ks_mac(y, key, ql, qt, rt),
        lambda: ma.ks_mac_plain(y, key, ql, qt, rt),
        *mac_cost(limb_cuda.mac_shape(y, [key], ql, None), y.element_size()))
    del y, keys, key
    if boot:
        cts = [random_residues(qall[lo:hi], (B, 2), N) for _ in range(8)]
        pts = random_residues(qall[lo:hi], (8,), N)
        res["diag_mac"] = measure(
            "diag_mac", [(lambda: ma.diag_mac(cts, pts, q, rinv),
                          lambda: ma.diag_mac_plain(cts, pts, q, rinv))],
            lambda: ma.diag_mac(cts, pts, q, rinv),
            lambda: ma.diag_mac_plain(cts, pts, q, rinv),
            pts.element_size() * (9 * cts[0].numel() + pts.numel()),
            (8, B, 2, hi - lo, N), cts[0].numel() * (
                8 * SLOTS_PER_PRODUCT + 2 * SLOTS_PER_GROUP_REDC))
    return res


def profile_summary(prof, wall: float) -> dict:
    """Device time by kernel from a stopped torch.profiler run, read from
    its raw events (``key_averages()`` parses every event in Python: ~2
    minutes for the half a million kernels of a layer pass): the wall
    time, the top 10 kernels, every NTT kernel and every limb kernel, and
    the device's busy share of ``wall``."""
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
                    for s, n, k in rows if "ntt_" in k],
            "limb": [{"s": s, "calls": n, "name": kernel_name(k)}
                     for s, n, k in rows
                     if kernel_name(k).split("<")[0] in KERNELS]}


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

    kern = check_kernels(ctx, "bootstrap")

    stages, mark = [], [0.0]

    def on_stage(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append((name, round(now - mark[0], 3)))
        mark[0] = now

    bt.on_stage = on_stage
    bt.encode_s = 0.0
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    mark[0] = time.perf_counter()
    out, prof = profile_pass(lambda: boot.fn(boot.x_data))
    bt.on_stage = None
    secs = prof["wall_s"]
    launches = launch_counts()
    shapes = launch_shapes()
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
    require_launches("bootstrap", launches, kern)
    require_int32("Bootstrap.fn's output", out.data)
    time_main_shapes(ctx, kern, shapes)
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
    if SHARED["keep"]:
        SHARED["bootstrap"] = boot
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
    timed pass that must launch each of its kernels, the oracle check.
    Returns the kernels' measurements with the pass's launches."""
    from moai_tpu_torch.entry import build_head
    t0 = time.time()
    held = torch.cuda.memory_allocated()        # earlier phases' objects
    head = build_head(**HEAD, device="cuda",
                      weights=bert_weights(np.random.default_rng(0),
                                           HEAD["d_model"], HEAD["head_dim"]))
    torch.cuda.synchronize()
    log(f"head set-up (context, keys, weights, encrypt) "
        f"{time.time() - t0:.1f} s; L={head.ctx.L} K={head.ctx.K} "
        f"x {tuple(head.x_data.shape)}")

    kern = check_kernels(head.ctx, "head")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    out = head.fn(head.x_data)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = launch_counts()
    shapes = launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    log(f"head: {secs:.2f} s, {secs / HEAD['input_count']:.4f} s per input, "
        f"peak {peak / 2**30:.2f} GiB, its own {(peak - held) / 2**30:.2f} "
        f"GiB above the {held / 2**30:.2f} GiB held when the phase began "
        f"(the bootstrap's, kept for the shard phase), output "
        f"n_q={out.n_q}, launches {launches}")
    require_launches("head", launches, kern)
    require_int32("the head's output", out.data)
    time_main_shapes(head.ctx, kern, shapes)

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
    if SHARED["keep"]:
        SHARED["head"] = head
    return kern


def sync_all(mesh) -> None:
    for d in mesh.distinct():
        torch.cuda.synchronize(d)


def sharded_vs_unsharded(name: str, mesh, unsharded, sharded, shapes: dict,
                         peak_limit=None, kept_limit=None) -> dict:
    """One program unsharded on the card and then sharded over ``mesh``, the
    launch counts set to 0 and the peak memory counters reset before each:
    the gathered output torch.equal to the unsharded one and every kernel
    the unsharded run launched launched again (both gated); with
    ``peak_limit`` (the unsharded run's peak in GiB and the sharded run's
    bytes moved and bytes copied by kind -> GiB), no card's peak in the
    sharded run above it (gated); with ``kept_limit`` (GiB), no card
    holding more than that after both runs, their outputs freed, than
    before them (gated).  Adds the sharded run's launch shapes
    (limb_cuda.shapes) to ``shapes``.  Returns the seconds, launches, the
    memory held before each run and kept after them, each card's peak,
    and the bytes moved between mesh positions and those copied."""
    from moai_tpu_torch.parallel import sharding
    gib = 2**30
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / gib
    before = {str(d): torch.cuda.memory_allocated(d) / gib
              for d in mesh.distinct()}
    t0 = time.perf_counter()
    want = unsharded()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated() / gib
    plain_launches = launch_counts()
    sync_all(mesh)
    for d in mesh.distinct():
        torch.cuda.reset_peak_memory_stats(d)
    held_sharded = {str(d): torch.cuda.memory_allocated(d) / gib
                    for d in mesh.distinct()}
    reset_launches()
    sharding.reset_moved()
    t0 = time.perf_counter()
    got = sharded()
    sync_all(mesh)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    for kind, counts in launch_shapes().items():
        for shape, n in counts.items():
            shapes[kind][shape] = shapes[kind].get(shape, 0) + n
    peak = {str(d): torch.cuda.max_memory_allocated(d) / gib
            for d in mesh.distinct()}
    rec = {"program": name, "mesh": [mesh.shape["col"], mesh.shape["limb"]],
           "devices": sorted({str(d) for d in mesh.distinct()}),
           "unsharded_s": plain_s, "sharded_s": secs,
           "unsharded_held_gib": held, "unsharded_peak_gib": plain_peak,
           "held_gib": held_sharded, "peak_gib": peak,
           "peak_limit_gib": None if peak_limit is None else
           peak_limit(plain_peak, sharding.moved, sharding.copied),
           "moved_bytes": dict(sharding.moved),
           "copied_bytes": dict(sharding.copied),
           "unsharded_launches": plain_launches, "launches": launches,
           "equal": bool(got.scale == want.scale
                         and got.data.shape == want.data.shape
                         and torch.equal(got.data, want.data))}
    require_int32(f"the sharded {name}'s output", got.data)
    del got, want
    rec["kept_gib"] = kept = {
        str(d): torch.cuda.memory_allocated(d) / gib - before[str(d)]
        for d in mesh.distinct()}
    log(f"shard {name} on mesh {mesh}: {json.dumps(rec)}")
    if not rec["equal"]:
        raise SystemExit(f"the sharded {name} differs from the unsharded one")
    missing = [k for k, v in plain_launches.items()
               if v > 0 and launches[k] <= 0]
    if missing:
        raise SystemExit(f"the sharded {name} launched no {missing}")
    limit = rec["peak_limit_gib"]
    if limit is not None and max(peak.values()) > limit:
        raise SystemExit(f"the sharded {name} peaked at {peak} GiB, above "
                         f"its limit of {limit:.2f} GiB (the unsharded run "
                         f"peaked at {plain_peak:.2f})")
    if kept_limit is not None and max(kept.values()) > kept_limit:
        raise SystemExit(f"the sharded {name} left {kept} GiB allocated, "
                         f"above its limit of {kept_limit} GiB")
    return rec


def shard_programs(boot, head, devices, meshes, shapes: dict) -> list:
    """The shard phase's programs over meshes of ``devices`` (``meshes``:
    the (col, limb) shapes by program, as SHARD_MESHES; each mesh takes
    the first of ``devices`` in order): records of sharded_vs_unsharded,
    the launch shapes of the sharded runs added to ``shapes``; the
    bootstrap's peak held to SHARD_BOOT_PEAK_RATIO."""
    from moai_tpu_torch.boot.bootstrap import make_refresh
    from moai_tpu_torch.ciphertext import Ciphertext
    from moai_tpu_torch.entry import evaluator_step
    from moai_tpu_torch.ops.matmul import ccmm_col_to_diag, col_chunk_for
    from moai_tpu_torch.parallel import sharding as sh
    home = devices[0]
    bctx = boot.ctx
    x = Ciphertext(boot.x_data, bctx.scale, True)
    plain_refresh = make_refresh(boot.bootstrapper)
    recs, boot_out = [], [None]

    def mesh_of(c, l):
        return sh.make_mesh(c * l, limb_axis=l, devices=devices[:c * l])

    for c, l in meshes["bootstrap"]:
        refresh = make_refresh(boot.bootstrapper, mesh=mesh_of(c, l))

        def unsharded():
            boot_out[0] = plain_refresh(x, boot.n_out)
            return boot_out[0]
        recs.append(sharded_vs_unsharded(
            "bootstrap (make_refresh)", mesh_of(c, l), unsharded,
            lambda: refresh(x, boot.n_out), shapes,
            lambda plain, *_: SHARD_BOOT_PEAK_RATIO * plain))
        del refresh
        gc.collect()
        torch.cuda.empty_cache()
    hctx = head.ctx
    n = SHARD_CCMM_COLUMNS
    hx = Ciphertext(head.x_data[:n], hctx.scale, True)
    hw = Ciphertext(head.x_data[n:2 * n], hctx.scale, True)
    chunk = col_chunk_for(hctx, hctx.L, head.num_row)
    for c, l in meshes["ccmm"]:
        mesh = mesh_of(c, l)
        sev = sh.ShardedEvaluator(head.ev, mesh)
        recs.append(sharded_vs_unsharded(
            f"ccmm_col_to_diag ({n} columns, num_row {head.num_row}, "
            f"col_chunk {chunk})", mesh,
            lambda: ccmm_col_to_diag(head.ev, hx, hw, head.num_x,
                                     head.num_row, col_chunk=chunk),
            lambda: sh.gather(sh.ccmm_col_to_diag_sharded(
                sev, sh.shard_ciphertext(hx, mesh, limb=l > 1),
                sh.shard_ciphertext(hw, mesh, limb=l > 1), head.num_x,
                head.num_row, chunk), home), shapes))
        del sev
        gc.collect()
        torch.cuda.empty_cache()
    a = boot_out[0]
    b = a.with_data(a.data.flip(0).contiguous())
    ev = boot.bootstrapper.ev
    for c, l in meshes["step"]:
        mesh = mesh_of(c, l)
        sev = sh.ShardedEvaluator(ev, mesh)
        recs.append(sharded_vs_unsharded(
            f"evaluator step ({a.batch_shape[0]} ciphertexts at {a.n_q} "
            f"limbs, limbs split)", mesh,
            lambda: evaluator_step(ev, a, b),
            lambda: sh.gather(evaluator_step(
                sev, sh.shard_ciphertext(a, mesh, limb=True),
                sh.shard_ciphertext(b, mesh, limb=True)), home), shapes))
        del sev
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def shard_head_programs(head, devices, meshes, shapes: dict,
                        gate: bool) -> list:
    """The head phase's head over meshes of ``devices`` (``meshes``: the
    (col, limb) shapes; the input at P("col", None, None, None) where the
    limb axis is 1, else at P("col", None, "limb", None)): records of
    sharded_vs_unsharded, the launch shapes of the sharded runs added to
    ``shapes``; with ``gate`` (one card), the sharded run's peak held to
    the unsharded run's peak plus the bytes its placement copied plus
    SHARD_HEAD_PEAK, and what it keeps to SHARD_HEAD_KEPT.  Logs each
    run's own peaks above the memory held before it."""
    from moai_tpu_torch.entry import shard_head
    from moai_tpu_torch.parallel import sharding as sh
    recs = []
    for c, l in meshes:
        mesh = sh.make_mesh(c * l, limb_axis=l, devices=devices[:c * l])
        S = shard_head(head, mesh, "limb" if l > 1 else "col")
        split = "col and limb" if l > 1 else "col"
        rec = sharded_vs_unsharded(
            f"head ({HEAD['d_model']} columns, the input over {split})", mesh,
            lambda: head.fn(head.x_data),
            lambda: sh.gather(S.fn(head.x_data), devices[0]), shapes,
            (lambda plain, moved, copied: plain + copied["scatter"] / 2**30
             + SHARD_HEAD_PEAK) if gate else None,
            SHARD_HEAD_KEPT if gate else None)
        own = {d: round(v - rec["held_gib"][d], 3)
               for d, v in rec["peak_gib"].items()}
        log(f"shard head on {rec['mesh']}: its own peak above the memory "
            f"held before it: unsharded "
            f"{rec['unsharded_peak_gib'] - rec['unsharded_held_gib']:.3f} "
            f"GiB (of {rec['unsharded_held_gib']:.3f} held), sharded "
            f"{json.dumps(own)} GiB; limit {rec['peak_limit_gib']} GiB; "
            f"kept after the runs {json.dumps(rec['kept_gib'])} GiB")
        recs.append(rec)
        del S
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def run_shard() -> dict:
    """The shard phase: the sharded programs on virtual meshes of cuda:0
    (and on real cards where there are several), each held torch.equal to
    its unsharded run, the head's last, after the bootstrap's objects are
    freed; then every kernel held against its plain version at a limb
    shard's window of the bootstrap's chain (the second position of the
    (1, 2) mesh after ModRaise: Q limbs [L/2, L), special limbs [K/2, K),
    the key rows read in place) and of the head's (Q [L/2, L), special
    [K/2, K)), and base_conv and ks_mac at the sharded runs' commonest
    launch shapes at each chain.  Returns the kernels' measurements of the
    paths "shard" (the launches of the bootstrap's, the CCMM's and the
    step's sharded runs) and "shard_head" (those of the head's)."""
    from moai_tpu_torch.entry import build_bootstrap, build_head
    from moai_tpu_torch.params import flagship_config
    t0 = time.time()
    boot = SHARED.pop("bootstrap", None)
    if boot is None:
        boot = build_bootstrap(flagship_config(), BOOT_BATCH, device="cuda")
    head = SHARED.pop("head", None)
    if head is None:
        head = build_head(**HEAD, device="cuda",
                          weights=bert_weights(np.random.default_rng(0),
                                               HEAD["d_model"],
                                               HEAD["head_dim"]))
    torch.cuda.synchronize()
    log(f"shard set-up {time.time() - t0:.1f} s (the bootstrap's and the "
        f"head's contexts and keys; built here only when their phases did "
        f"not run); {torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    card0 = torch.device("cuda", 0)
    n = torch.cuda.device_count()
    real = [torch.device("cuda", i) for i in range(n)]
    meshes = {k: [m for m in v if m[0] * m[1] <= n]
              for k, v in SHARD_MESHES.items()}
    shapes = {"base_conv": {}, "ks_mac": {}}
    recs = shard_programs(boot, head, [card0] * 4, SHARD_MESHES, shapes)
    if n > 1:
        log(f"shard on real cards: {n} cards, meshes {meshes}")
        recs += shard_programs(boot, head, real, meshes, shapes)
    else:
        log(f"shard on real cards: not possible, this host has {n} card "
            f"(a mesh of real cards needs two or more)")
    ctx = boot.ctx
    del boot
    gc.collect()
    torch.cuda.empty_cache()
    log(f"shard: the bootstrap's objects freed, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    head_shapes = {"base_conv": {}, "ks_mac": {}}
    head_recs = shard_head_programs(head, [card0] * 4, SHARD_MESHES["head"],
                                    head_shapes, gate=True)
    if n > 1:
        head_recs += shard_head_programs(head, real, meshes["head"],
                                         head_shapes, gate=False)
    hctx = head.ctx
    del head
    gc.collect()
    torch.cuda.empty_cache()
    paths = {}
    for path, rs, c, pshapes in (("shard", recs, ctx, shapes),
                                 ("shard_head", head_recs, hctx,
                                  head_shapes)):
        total = dict.fromkeys(KERNELS, 0)
        for r in rs:
            for k in KERNELS:
                total[k] += r["launches"][k]
        log(f"{path}: {len(rs)} sharded runs, each equal to its unsharded "
            f"run; launches in the sharded runs {total}")
        window = (c.L // 2, c.L, c.K // 2, c.K)
        log(f"{path} kernels at the window Q {window[:2]}, special "
            f"{window[2:]} of the {'head' if rs is head_recs else 'bootstrap'}"
            f"'s chain")
        kern = check_kernels(c, path, window)
        require_launches(path, total, kern)
        # the launches at the chain's N (the CCMM of the "shard" path runs
        # on the head's chain)
        N = c.cfg.N
        time_main_shapes(c, kern, {
            k: {s: m for s, m in v.items()
                if s[5 if k == "base_conv" else 4] == N}
            for k, v in pshapes.items()})
        paths[path] = kern
    return paths


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

    kern = check_kernels(layer.ctx, "layer")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, prof = profile_pass(lambda: layer.fn(layer.x_data))
    secs = prof["wall_s"]
    launches = launch_counts()
    shapes = launch_shapes()
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
    require_launches("layer", launches, kern)
    require_int32("the layer's output", out.data)
    time_main_shapes(layer.ctx, kern, shapes)

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
        require_int32(f"layer {i}'s checkpoint, reloaded", back.data)
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

    kern = check_kernels(model.ctx, "model")

    ev, n_ref = first.ev, len(LAYER_STAGES)
    trace = OpTrace()
    prof = profile(activities=[ProfilerActivity.CUDA])
    check_launches = dict.fromkeys(KERNELS, 0)
    plain_in = [model.xs]
    mark = [0.0]

    def on_layer(i, ct):
        torch.cuda.synchronize()
        secs = time.perf_counter() - mark[0]
        require_int32(f"layer {i}'s output, handed to on_layer", ct.data)
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
        before = launch_counts()
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
        after = launch_counts()
        for k in KERNELS:
            check_launches[k] += after[k] - before[k]
        log(f"model layer {i}: {json.dumps(rec)}")
        if prof_rec is not None:
            log(f"model layer {i} profile:", json.dumps(prof_rec))
        if rec["err"] > LAYER_ATOL:
            raise SystemExit(f"layer {i} output outside tolerance")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        mark[0] = time.perf_counter()

    reset_launches()
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
    total = launch_counts()
    shapes = launch_shapes()
    launches = {k: total[k] - check_launches[k] for k in KERNELS}
    log(f"model: {MODEL_LAYERS} layers and their checks in {secs:.2f} s; "
        f"output n_q={out.n_q}; launches in the layers {launches}, in the "
        f"checks between them (not counted) {check_launches}; OpTrace of "
        f"layer 0: {len(trace.events)} ops {json.dumps(trace.summary())}, "
        f"lowest n_q {trace.min_n_q()}")
    require_launches("model", launches, kern)
    if out.n_q != first.n_att:
        raise SystemExit(f"model output at {out.n_q} limbs, not "
                         f"{first.n_att}")
    del out
    time_main_shapes(model.ctx, kern, shapes)
    return kern


def run_kernels() -> None:
    """The limb kernels alone (only when named): each path's context on the
    card (flagship_config, the head's head_config(15, 16), the model's
    head_config(15, 13)), the limb kernels held torch.equal to their plain
    versions and timed at that path's checked shapes, as each phase does,
    and base_conv and ks_mac at its MAIN_SHAPES; the log lines carry the
    numbers.  With MOAI_LIMB_SOURCE naming another
    limb.cu, the kernels are built from it, so two versions can be timed
    in one call."""
    from moai_tpu_torch.params import Context, flagship_config, head_config
    for path, cfg in (("bootstrap", flagship_config()),
                      ("head", head_config(15, 16)),
                      ("model", head_config(15, 13))):
        log(f"kernels at the {path}'s chain")
        ctx = Context(cfg, device="cuda")
        kern = check_limb_kernels(ctx, path)
        conv, mac, hoisted = MAIN_SHAPES[path]
        time_main_shapes(ctx, kern, {"base_conv": {conv: 1},
                                     "ks_mac": {mac: 1, hoisted: 0}})
        del ctx, kern
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pathlib import Path
    from moai_tpu_torch import cuda_build
    if os.environ.get("MOAI_LIMB_SOURCE"):
        cuda_build.SOURCES["limb"] = Path(os.environ["MOAI_LIMB_SOURCE"])
        log(f"limb kernels from {cuda_build.SOURCES['limb']}")

    t0 = time.time()
    for lib, msgs in cuda_build.build().values():
        log(f"built {lib.name} ({time.time() - t0:.1f} s since the start of "
            f"the builds, which run in parallel)")
        for line in msgs.splitlines():
            if any(w in line for w in ("entry function", "registers", "smem",
                                       "spill")):
                log("  nvcc:", line.strip())
        for fn, mix in sass_mix(lib).items():
            log(f"  SASS {fn}: {sum(mix.values())} instructions, "
                f"{json.dumps(dict(sorted(mix.items(), key=lambda kv: -kv[1])))}")
    name_power = card()
    INT32_OPS_PER_S[0] = int32_ops_per_s()
    log(f"card: {name_power}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; INT32 rate {INT32_OPS_PER_S[0]:.4e} lanes/s "
        f"({INT32_LANES_PER_SM} lanes per SM, the maximum SM clock)")

    phases = {"bootstrap": run_bootstrap, "head": run_head,
              "shard": run_shard, "model": run_model, "layer": run_layer,
              "kernels": run_kernels}
    chosen = sys.argv[1:] or ["bootstrap", "head", "shard", "model"]
    unknown = set(chosen) - set(phases)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    SHARED["keep"] = "shard" in chosen
    paths = {}
    for name in chosen:
        kern = phases[name]()
        if name == "shard":
            paths.update(kern)
        elif kern is not None:
            paths[name] = kern
        gc.collect()
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][0], "launches": m[k]["launches"],
         "max_abs_err": m[k]["max_abs_err"], "ms": m[k]["ms"],
         "plain_ms": m[k]["plain_ms"], "bound_ms": m[k]["bound_ms"],
         "bound_by": m[k].get("bound_by", "bytes"), "library_ms": None,
         "path": path, "shape": m[k]["shape"], "device_ms": m[k]["device_ms"],
         **{x: m[k][x] for x in ("bound_bytes_ms", "bound_ops_ms", "main",
                                 "hoisted") if x in m[k]}}
        for path, m in paths.items() for k in PATH_KERNELS[path]]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
