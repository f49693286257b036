"""device_busy_s.<cell kind>: seconds per pass in which an operation ran
on the device (the union of CUDA activity in the profiled whole passes,
over the passes): the device's share of a pass, steadier than the host
clock where the host sets the pace."""


def read(rec: dict) -> float | None:
    prof = rec.get("profile")
    if not prof or not prof["passes"] or prof["busy_s"] <= 0:
        return None
    return prof["busy_s"] / prof["passes"]
