"""Observability: per-op level/scale tracing and per-stage wall timers.

Port of ``moai_tpu/utils/debug.py``, with the same fields and printouts:

- ``OpTrace``: attach to ``Evaluator.debug``; it records each hooked
  evaluator op with the result's (n_q, scale).  Torch runs eagerly, so the
  hook fires as each op returns (the JAX package's fires while tracing).
- ``StageTimer``: wall-clock stage timing for scripts and benches (prints
  one line per stage and accumulates a dict for JSON output).
- ``NoiseProbe``: harness-side decrypt hook giving the error of a
  ciphertext against an expected slot vector (it takes a ``Decryptor``, so
  it stays on the side that holds the secret key).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


class OpTrace:
    """Evaluator.debug hook: records (op, n_q, scale) per op call.

    with_print=True emits one line per op.  ``summary()`` aggregates op
    counts.
    """

    def __init__(self, with_print: bool = False, log2_scale: bool = True):
        self.events: list[tuple[str, int, float]] = []
        self.with_print = with_print
        self.log2_scale = log2_scale

    def __call__(self, op: str, ct) -> None:
        scale = float(ct.scale)
        self.events.append((op, ct.n_q, scale))
        if self.with_print:
            s = np.log2(scale) if self.log2_scale else scale
            print(f"[moai] {op:<18} n_q={ct.n_q:<3} "
                  f"log2(scale)={s:.3f}")

    def summary(self) -> dict:
        counts: dict[str, int] = {}
        for op, *_ in self.events:
            counts[op] = counts.get(op, 0) + 1
        return counts

    def min_n_q(self) -> int:
        return min((n for _, n, _ in self.events), default=0)


class StageTimer:
    """Per-stage timing: ``with timer("softmax"): ...``.

    Blocks on the stage's output (``block``) so device work is attributed
    to the right stage despite asynchronous launches.
    """

    def __init__(self, verbose: bool = True):
        self.stages: dict[str, float] = {}
        self.verbose = verbose
        self._name: Optional[str] = None
        self._t0 = 0.0

    def __call__(self, name: str) -> "StageTimer":
        self._name = name
        return self

    def __enter__(self) -> "StageTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        name = self._name or f"stage{len(self.stages)}"
        self.stages[name] = self.stages.get(name, 0.0) + dt
        if self.verbose:
            print(f"[moai] {name:<28} {dt:8.3f} s")

    def block(self, ct) -> None:
        """Wait for a ciphertext's (or a tensor's) device so the stage
        absorbs its device time; a tensor on the CPU is already done."""
        data = getattr(ct, "data", ct)
        if data.device.type == "cuda":
            torch.cuda.synchronize(data.device)

    def total(self) -> float:
        return sum(self.stages.values())

    def as_dict(self) -> dict:
        return {k: round(v, 4) for k, v in self.stages.items()}


class NoiseProbe:
    """Harness-side decrypt oracle: max |decrypt(ct) - expected| per probe
    (with no expectation, the largest imaginary part)."""

    def __init__(self, decryptor, verbose: bool = True):
        self.decryptor = decryptor
        self.verbose = verbose
        self.probes: list[tuple[str, float]] = []

    def __call__(self, name: str, ct, expected=None) -> float:
        got = self.decryptor.decrypt(ct)
        if expected is None:
            err = float(np.max(np.abs(got.imag)))
        else:
            err = float(np.max(np.abs(got.real - np.asarray(expected))))
        self.probes.append((name, err))
        if self.verbose:
            print(f"[moai] probe {name:<22} max_err={err:.3e} "
                  f"n_q={ct.n_q}")
        return err
