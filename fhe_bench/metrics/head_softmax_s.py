"""head_softmax_s: seconds per pass in the softmax (softmax_diag),
from synchronised spans the traced run puts around these calls as
moai_tpu_torch.entry makes them."""


def read(rec: dict) -> float | None:
    return rec.get("spans", {}).get("head_softmax_s")
