"""keyswitches.<cell kind>: key switches per pass, from the recorder on
Evaluator.debug: one per relinearize and apply_galois, one per rotation of
a hoisted call."""


def read(rec: dict) -> float | None:
    return rec.get("keyswitches")
