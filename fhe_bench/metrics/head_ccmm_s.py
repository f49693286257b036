"""head_ccmm_s: seconds per pass in both CCMMs (ccmm_col_to_diag, ccmm_diag_to_col),
from synchronised spans the traced run puts around these calls as
moai_tpu_torch.entry makes them."""


def read(rec: dict) -> float | None:
    return rec.get("spans", {}).get("head_ccmm_s")
