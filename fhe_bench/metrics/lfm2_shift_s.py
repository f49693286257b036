"""lfm2_shift_s: seconds per pass in the causal shift conv (the hoisted
rotations, the mask-and-tap products, their sum and rescale), from
synchronised spans the traced run puts around EncryptedShortConv.shift
as the mixer calls it."""


def read(rec: dict) -> float | None:
    return rec.get("spans", {}).get("lfm2_shift_s")
