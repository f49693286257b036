"""Observability: per-op level/scale tracing, spans at the program's layer
boundaries, and a decrypt probe.

Port of ``moai_tpu/utils/debug.py`` (``OpTrace`` and ``NoiseProbe``, with
the same fields and printouts), and the port's span recorder:

- ``OpTrace``: attach to ``Evaluator.debug``; it records each hooked
  evaluator op with the result's (n_q, scale).  Torch runs eagerly, so the
  hook fires as each op returns (the JAX package's fires while tracing).
- ``span(name)``: a context manager the program opens at each layer
  boundary (the head's pass, its matmuls and softmax, the host encoder, the
  bootstrap's stages, set-up's context and keys, the kernels' build);
  ``spanned(name)`` puts a whole function inside one.
  Recording is off by default: ``span`` then returns one shared null
  context after one global check.  Inside ``tracing()`` each span records
  its name, its parent, its pass (the outermost open span), its host start
  and end (``time.perf_counter_ns``) and the port's kernel-launch total
  (``ntt_cuda.launches`` + ``limb_cuda.launches`` +
  ``modmat_cuda.launches``) at both ends, into the
  ``Trace`` that ``tracing`` yields.  A span never synchronises and never
  touches the device: it says what the host was doing.  The device's side
  comes from a profiler trace, which ``Trace.epoch_ns`` puts spans beside
  (kineto's events are Unix-epoch nanoseconds).
- ``NoiseProbe``: harness-side decrypt hook giving the error of a
  ciphertext against an expected slot vector (it takes a ``Decryptor``, so
  it stays on the side that holds the secret key).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import numpy as np


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


# -- spans ------------------------------------------------------------------

@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span.  ``parent`` and ``pass_id`` index
    ``Trace.spans`` (-1: no parent; a root is its own pass); times are
    ``perf_counter_ns`` readings, ``end_ns`` -1 while the span is open;
    ``launches_*`` the port's launch total at each end."""
    name: str
    parent: int
    pass_id: int
    start_ns: int
    end_ns: int
    launches_start: int
    launches_end: int

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def launches(self) -> int:
        return self.launches_end - self.launches_start


class Trace:
    """The spans of one ``tracing()`` block, in the order they opened, and
    the anchor that puts them on the Unix-epoch clock."""

    ANCHOR_READS = 8

    def __init__(self):
        from .. import limb_cuda, modmat_cuda, ntt_cuda
        self.spans: list[Span] = []
        self._open: list[int] = []
        self._counters = (ntt_cuda.launches, limb_cuda.launches,
                          modmat_cuda.launches)
        # the tightest of a few (perf_counter_ns, time_ns) pairs read back
        # to back: the epoch reading against the mid-point of its bracket
        best = None
        for _ in range(self.ANCHOR_READS):
            a = time.perf_counter_ns()
            e = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, (a + b) // 2, e)
        _, self.anchor_perf_ns, self.anchor_epoch_ns = best

    def launches(self) -> int:
        """The port's kernel launches so far (all its counters)."""
        return sum(sum(c.values()) for c in self._counters)

    def epoch_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` reading as Unix-epoch nanoseconds, the
        clock of torch.profiler's kineto events (``e.start_ns()``)."""
        return t - self.anchor_perf_ns + self.anchor_epoch_ns

    def path(self, i: int) -> str:
        """Span ``i``'s name after its ancestors', joined by "/"."""
        names = []
        while i >= 0:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return "/".join(reversed(names))

    def open(self, name: str) -> int:
        i = len(self.spans)
        top = self._open[-1] if self._open else -1
        root = self._open[0] if self._open else i
        self.spans.append(Span(name, top, root, time.perf_counter_ns(), -1,
                               self.launches(), -1))
        self._open.append(i)
        return i

    def close(self, i: int) -> None:
        s = self.spans[i]
        s.launches_end = self.launches()
        s.end_ns = time.perf_counter_ns()
        del self._open[self._open.index(i):]


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


class _Recording:
    __slots__ = ("trace", "name", "index")

    def __init__(self, trace: Trace, name: str):
        self.trace, self.name = trace, name

    def __enter__(self) -> Span:
        self.index = self.trace.open(self.name)
        return self.trace.spans[self.index]

    def __exit__(self, *exc) -> bool:
        # runs on an exception too, so a span is always closed
        self.trace.close(self.index)
        return False


NULL_SPAN = _NullSpan()
_trace: Trace | None = None


def span(name: str):
    """A span around the work of its ``with`` block (see the module's
    docstring); the shared ``NULL_SPAN`` when nothing records."""
    if _trace is None:
        return NULL_SPAN
    return _Recording(_trace, name)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def tracing():
    """Record every span opened in the block into the ``Trace`` it
    yields (kept in memory; nothing is written out)."""
    global _trace
    outer, trace = _trace, Trace()
    _trace = trace
    try:
        yield trace
    finally:
        _trace = outer
