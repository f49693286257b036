"""idle_share.<cell kind>: 1 - device-busy time / wall time of the
profiled whole passes, in % (CUDA activity only, busy as the union of the
activity intervals)."""


def read(rec: dict) -> float | None:
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
