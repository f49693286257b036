"""lfm2_gate_s: seconds per pass in the two gating products (B * x and C *
v, each multiply, relinearize and rescale), from synchronised spans the
traced run puts around EncryptedShortConv.gate as the mixer calls it."""


def read(rec: dict) -> float | None:
    return rec.get("spans", {}).get("lfm2_gate_s")
