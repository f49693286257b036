"""A kernel's share of its roofline in the profiled passes, from the
launch shapes the program records and a bound per launch shape.

The bounds follow ``work/cost.py``'s convention: each input read once and
each output written once at ``cost.HBM_BYTES_PER_S``, or the least INT32
issue slots at ``cost.INT32_SLOTS_PER_S`` where that is larger
(``cost.bound_s``).  Each metric file of this kind holds its kernel's
bound and reads through ``share``.
"""

from __future__ import annotations


def share(rec: dict, kernels, shapes: dict | None, bound_s) -> float | None:
    """100 x the sum of the launches' bounds (``shapes``: launch shape ->
    launches, each bounded by ``bound_s``) over the device time of the
    profiled kernels named ``kernels`` (``profile["port"]``, the same
    passes), in %; None without a profile whose kernel count agrees with
    the launch counters, without a launch shape, or without device time."""
    prof = rec.get("profile")
    if not prof or not prof["matched"] or not shapes:
        return None
    secs = sum(prof["port"][k][0] for k in kernels if k in prof["port"])
    bound = sum(n * bound_s(s) for s, n in shapes.items())
    return 100.0 * bound / secs if bound and secs else None
