"""head_cpmm_s: seconds per pass in the Q, K and V CPMMs (CPMM.__call__),
from synchronised spans the traced run puts around these calls as
moai_tpu_torch.entry makes them."""


def read(rec: dict) -> float | None:
    return rec.get("spans", {}).get("head_cpmm_s")
