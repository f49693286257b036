"""ntt_roofline.<cell kind>: the NTT kernels' share of their roofline in
the profiled passes, in %: the bounds of the launch shapes
``ntt_cuda.shapes`` recorded over the device time of ``ntt_cols`` and
``ntt_rows`` (a launch is one of each).

A launch shape is (rows, active limbs, log N).  Its bound: the rows read
and written once, 4 bytes a coefficient, or the least INT32 slots of the
butterflies (``work/cost.py``'s ``_ntt_slots``); the twiddle tables are
not counted, as the port's smoke run counts them.

The profile copies limb_cuda's launch shapes but not ntt_cuda's, so this
reads ``ntt_cuda.shapes`` after the traced run: the profiled passes and
the whole passes run after them, all alike (a pass is data-oblivious).
Each shape's count is scaled to the profiled passes' launches, and the
metric is None unless the counts hold a whole number of those passes."""

from fhe_bench.roofline import share
from fhe_bench.work import cost

KERNELS = ("ntt_cols", "ntt_rows")


def bound_s(shape) -> float:
    rows, _, log_n = shape
    N = 1 << log_n
    return cost.bound_s(2 * cost.RESIDUE_BYTES * rows * N,
                        cost._ntt_slots(rows, N))


def profiled_shapes(prof: dict) -> dict | None:
    """ntt_cuda's launch shapes, both directions, scaled to the launches
    of the profiled passes; None where the program records none or the
    counts are not a whole number of those passes."""
    from moai_tpu_torch import ntt_cuda
    recorded = getattr(ntt_cuda, "shapes", None)
    if not recorded:
        return None
    out = {}
    for name, counts in recorded.items():
        profiled, counted = prof["launches"].get(name, 0), \
            sum(counts.values())
        if not profiled:
            continue
        if counted * prof["passes"] % profiled:
            return None
        for s, n in counts.items():
            out[s] = out.get(s, 0) + n * profiled / counted
    return out


def read(rec: dict) -> float | None:
    prof = rec.get("profile")
    if not prof or not prof["matched"]:
        return None
    return share(rec, KERNELS, profiled_shapes(prof), bound_s)
