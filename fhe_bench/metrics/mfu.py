"""mfu.<cell kind>: the pass's least time over its mean time, in %.

The least time is ``work.cost.pass_least_s`` of the frozen primitive
counts in ``work/<config>.json`` (recorded once from a pass at the
configuration), the batch scaled to the cell's; the mean time is that of
the traced run's window, with the profiler off."""

from fhe_bench.work import cost


def read(rec: dict) -> float | None:
    if not rec.get("work") or not rec.get("pass_s"):
        return None
    return 100.0 * cost.pass_least_s(rec["work"], rec["batch"]) / \
        rec["pass_s"]
