"""lfm2_outproj_s: seconds per pass in the row-parallel out_proj
(CPMM.product over the held rows and finish), from synchronised spans
the traced run puts around EncryptedShortConv.out_proj as the mixer
calls it."""


def read(rec: dict) -> float | None:
    return rec.get("spans", {}).get("lfm2_outproj_s")
