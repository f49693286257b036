"""limb_ew_roofline.<cell kind>: limb_cuda.limb_ew's share of its roofline
in the profiled passes, in %: the bounds of the launch shapes
``limb_cuda.shapes["limb_ew"]`` recorded over the device time of
``limb_ew``.

A launch shape is (op, output elements, then the distinct elements of
each operand a, b, c, q, a broadcast axis counted once).  Its bound: each
distinct operand element read and each output written once, 4 bytes each,
or the op's least INT32 slots per output (a modular add, subtract or
negate ``SLOTS_PER_ADD``; a Montgomery product or reduction
``SLOTS_PER_EW_MUL``; the fused subtract-and-multiply both)."""

from fhe_bench.roofline import share
from fhe_bench.work import cost

SLOTS = {"add": cost.SLOTS_PER_ADD, "sub": cost.SLOTS_PER_ADD,
         "neg": cost.SLOTS_PER_ADD, "mul": cost.SLOTS_PER_EW_MUL,
         "from_mont": cost.SLOTS_PER_EW_MUL,
         "sub_mul": cost.SLOTS_PER_ADD + cost.SLOTS_PER_EW_MUL}


def bound_s(shape) -> float:
    op, out, *operands = shape
    return cost.bound_s(cost.RESIDUE_BYTES * (out + sum(operands)),
                        SLOTS[op] * out)


def read(rec: dict) -> float | None:
    prof = rec.get("profile") or {}
    return share(rec, ("limb_ew",), prof.get("shapes", {}).get("limb_ew"),
                 bound_s)
