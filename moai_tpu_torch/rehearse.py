"""Rehearse ``chip_smoke.py``'s bootstrap phase at a small ring degree.

    python -m moai_tpu_torch.rehearse --device cpu [--logN 11]
        [--evalmod-degree 59]

Builds ``flagship_config``'s chain (q0 pair, 20 data pairs of 26 bits, 16
boot pairs of 29 bits, dnum 6, hw 192) at ``--logN`` instead of 16, and
runs ``entry.build_bootstrap`` on it as ``chip_smoke.py`` does at N = 2^16
(two ciphertexts, seed 11):
the same levels and scales, the same lt_group rule (dense at n <= 512).
Prints the set-up seconds, the seconds per stage and per pass, the error
against the input (real and imaginary parts), EvalMod's error at the
integer centres with the worst case it can add coherently to the slots,
and the host's SHAKE-256 DRBG rate, which bounds key generation.  Times
are host-clock seconds on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .boot.bootstrap import EVALMOD_DEGREE
from .csprng import ShakeRng
from .entry import build_bootstrap
from .params import CKKSConfig


def drbg_mb_per_s(mb: int = 64) -> float:
    rng = ShakeRng(0)
    t0 = time.perf_counter()
    for _ in range(mb * 2):
        rng._u64(1 << 16)
    return mb / (time.perf_counter() - t0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--logN", type=int, default=11)
    ap.add_argument("--evalmod-degree", type=int, default=EVALMOD_DEGREE)
    a = ap.parse_args()
    cfg = CKKSConfig(logN=a.logN, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                     n_data_levels=20, boot_pair_bits=29.0, n_boot_levels=16,
                     dnum=6, hamming_weight=192)
    t0 = time.perf_counter()
    B = build_bootstrap(cfg, 2, evalmod_degree=a.evalmod_degree,
                        device=a.device)
    bt = B.bootstrapper
    stages, mark = [], [time.perf_counter()]

    def on_stage(name):
        if B.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append((name, round(now - mark[0], 3)))
        mark[0] = now

    bt.on_stage = on_stage
    t1 = time.perf_counter()
    mark[0] = t1
    out = B.fn(B.x_data)
    if B.ctx.device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = B.decode(out)
    b = bt.mr.centre_error()
    print(json.dumps({
        "device": str(B.ctx.device), "logN": a.logN, "L": B.ctx.L,
        "K": B.ctx.K, "levels": bt.levels, "n_out": out.n_q,
        "diagonals": [len(v) for v in bt.c2s_levels + bt.s2c_levels],
        "evalmod_degree": bt.mr.degree, "arcsin_deg": bt.mr.arcsin_deg,
        "setup_s": B.setup_s, "build_s": t1 - t0, "pass_s": t2 - t1,
        "stages_s": stages,
        "err_real": float(np.abs(got.real - B.values).max()),
        "err_imag": float(np.abs(got.imag).max()),
        "centre_error_max": float(np.abs(b).max()),
        "coherent_bound": bt.coherent_error_bound(),
        "drbg_mb_per_s": drbg_mb_per_s()}))


if __name__ == "__main__":
    main()
