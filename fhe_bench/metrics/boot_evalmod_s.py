"""boot_evalmod_s: seconds per ciphertext in the bootstrap's EvalMod stages (real and imaginary), from
synchronised Bootstrapper.on_stage spans over one pass."""


def read(rec: dict) -> float | None:
    s = rec.get("spans", {}).get("boot_evalmod_s")
    return None if s is None else s / rec["items"]
