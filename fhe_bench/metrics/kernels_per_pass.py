"""kernels_per_pass.<cell kind>: device kernels the profiler recorded per
pass (copies and fills left out): the eager torch ops' kernels and the
port's ctypes launches."""


def read(rec: dict) -> float | None:
    prof = rec.get("profile")
    if not prof or not prof["passes"]:
        return None
    return prof["kernels"] / prof["passes"]
