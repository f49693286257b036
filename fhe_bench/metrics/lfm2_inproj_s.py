"""lfm2_inproj_s: seconds per pass in the share's in_proj CPMM (2048 input
columns to the held channels' B, C and x), from synchronised spans the
traced run puts around EncryptedShortConv.in_proj as the mixer calls it."""


def read(rec: dict) -> float | None:
    return rec.get("spans", {}).get("lfm2_inproj_s")
