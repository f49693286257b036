"""diag_mac_roofline.<cell kind>: limb_cuda.diag_mac's share of its
roofline in the profiled passes, in %: the bounds of the launch shapes
``limb_cuda.shapes["diag_mac"]`` recorded over the device time of
``diag_mac``.

A launch shape is (terms, B, L, N): one giant step's sum of ``terms``
products of a ciphertext operand [B, L, N] by a diagonal [L, N].  Its
bound: every operand and diagonal read and the output written once, 4
bytes an element, or the least INT32 slots (a product for each term and
one grouped REDC per four, ``work/cost.least_s``'s diag_mac count)."""

from fhe_bench.roofline import share
from fhe_bench.work import cost


def bound_s(shape) -> float:
    terms, B, L, N = shape
    outs = B * L * N
    return cost.bound_s(
        cost.RESIDUE_BYTES * (terms * outs + terms * L * N + outs),
        outs * (terms * cost.SLOTS_PER_PRODUCT
                + cost.SLOTS_PER_GROUP_REDC * -(-terms // 4)))


def read(rec: dict) -> float | None:
    prof = rec.get("profile") or {}
    return share(rec, ("diag_mac",), prof.get("shapes", {}).get("diag_mac"),
                 bound_s)
