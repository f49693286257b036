"""The yardstick's frozen cost arithmetic: the card's peaks, a kernel's
bound from its launch shape, and a homomorphic primitive's least time.

Peaks of one NVIDIA H100 SXM (data sheet; the white paper for the INT32
lanes): HBM3 at 3.35 TB/s; INT32 issue slots at 64 lanes per SM x 132 SMs
x the maximum SM clock of 1980 MHz; dense int8 tensor-core products at
1979 TOP/s.  A bound is the larger of bytes / HBM_BYTES_PER_S and INT32
slots / INT32_SLOTS_PER_S (or int8 operations / INT8_OPS_PER_S): the least
time the card could take.

``conv_cost`` and ``mac_cost`` are the bounds of ``base_conv`` and
``ks_mac`` from their launch shapes (``limb_cuda.conv_shape`` and
``mac_shape``), as the port's smoke run states them: each input read once,
each output written once, and the least INT32 slots their arithmetic
issues.

``least_s`` is the least time of one homomorphic primitive, as
``capture_work.py`` records it in ``work/<config>.json``.  Its bytes are
the primitive's own: each input ciphertext, key and plaintext read once,
each output written once, nothing in between.  Its operations are the
NTT butterflies and modular products of the port's hybrid key switch and
of the other primitives at their shapes.  Every count errs low, so the
least time is a lower bound and a share of it cannot pass 100%.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
H100_SMS = 132
MAX_SM_MHZ = 1980.0
INT32_SLOTS_PER_S = INT32_LANES_PER_SM * H100_SMS * MAX_SM_MHZ * 1e6
INT8_OPS_PER_S = 1979e12
RESIDUE_BYTES = 4               # int32 residues at rest
INDEX_BYTES = 8                 # an int64 permutation entry

# Least INT32 issue slots of each step (the port's SASS: a 32x32 -> 64-bit
# multiply-add is one IMAD.WIDE.U32, two slots).  base_conv's two-step
# reduction of a 64-bit sum: ten; one REDC of a group of up to four
# products with its canonical add: eight; the conversion of an input (a
# product and one REDC): seven; a Montgomery product of one element with
# its reduction: eight.  An NTT butterfly: one product and an add and a
# subtract (reductions can be lazy, so none is counted); a modular add:
# an add and a conditional subtract.
SLOTS_PER_PRODUCT = 2
SLOTS_PER_REDC2 = 10
SLOTS_PER_GROUP_REDC = 8
SLOTS_PER_CONVERT = 7
SLOTS_PER_EW_MUL = 8
SLOTS_PER_BUTTERFLY = 4
SLOTS_PER_ADD = 2
CPMM_DIGITS = 4                 # int8 digits of a residue (modmat.NDIG)
UNSCALED = ("mod_matmul", "dyadic_sum")


def bound_s(nbytes: float, slots: float = 0.0, int8_ops: float = 0.0
            ) -> float:
    return max(nbytes / HBM_BYTES_PER_S, slots / INT32_SLOTS_PER_S,
               int8_ops / INT8_OPS_PER_S)


def conv_cost(shape, elt: int = RESIDUE_BYTES) -> tuple[int, int]:
    """base_conv's (bytes, least INT32 slots) from its launch shape (B, S,
    D, A, T, N, with hatinv, with k): products, one two-step reduction per
    sum of up to 16 products, the input conversions, ModRaise's k term."""
    B, S, D, A, T, N, hatinv, k = shape
    cnts = [min(A, S - d * A) for d in range(D)]
    slots = B * N * T * (SLOTS_PER_PRODUCT * sum(cnts) + SLOTS_PER_REDC2
                         * sum(-(-c // 16) for c in cnts))
    slots += SLOTS_PER_CONVERT * B * S * N if hatinv else 0
    slots += SLOTS_PER_GROUP_REDC * B * D * T * N if k else 0
    return elt * B * N * (S + D * T + (1 if k else 0)), slots


def mac_cost(shape, elt: int = RESIDUE_BYTES) -> tuple[int, int]:
    """ks_mac's (bytes, least INT32 slots) from its launch shape (R, B, D,
    T, N, KL, q_limbs, with perm): y, both key rows of the T targets per
    rotation, the output; each output a sum of D products, REDC'd in
    groups of four."""
    R, B, D, T, N, KL, q_limbs, with_perm = shape
    outs = 2 * R * B * T * N
    nbytes = (elt * (B * D * T * N + R * D * 2 * T * N + outs)
              + (INDEX_BYTES * R * N if with_perm else 0))
    return nbytes, outs * (SLOTS_PER_PRODUCT * D
                           + SLOTS_PER_GROUP_REDC * -(-D // 4))


def kernel_bound_s(kernel: str, shape) -> float:
    cost = {"base_conv": conv_cost, "ks_mac": mac_cost}[kernel]
    return bound_s(*cost(tuple(shape)))


# -- primitives ---------------------------------------------------------

def _ntt_slots(rows: int, N: int) -> int:
    return rows * (N // 2) * int(math.log2(N)) * SLOTS_PER_BUTTERFLY


def _digits(ctx: dict, n_q: int) -> int:
    return sum(1 for lo, _ in ctx["digit_ranges"] if lo < n_q)


def _mod_down_slots(ctx: dict, B: int, n_q: int) -> int:
    """One mod-down by P of a [B, n_q + K, N] accumulator: the K special
    limbs back to coefficients, converted to the n_q limbs, transformed,
    and the fused subtract-and-multiply by P^-1."""
    N, K = ctx["N"], ctx["K"]
    _, conv = conv_cost((B, K, 1, K, n_q, N, True, False))
    return (_ntt_slots(B * K, N) + conv + _ntt_slots(B * n_q, N)
            + (SLOTS_PER_EW_MUL + SLOTS_PER_ADD) * B * n_q * N)


def _switch_slots(ctx: dict, B: int, n_q: int, R: int, perm: bool) -> int:
    """A hybrid key switch of one [B, n_q, N] polynomial against R keys:
    to coefficients, the digits' base extension to the n_q + K targets,
    their NTTs, the MAC against each key, two mod-downs per key, the adds
    to c0."""
    N, K = ctx["N"], ctx["K"]
    D, A, T = _digits(ctx, n_q), ctx["alpha"], n_q + K
    _, conv = conv_cost((B, n_q, D, A, T, N, True, False))
    _, mac = mac_cost((R, B, D, T, N, ctx["L"] + K, ctx["L"], perm))
    return (_ntt_slots(B * n_q, N) + conv + _ntt_slots(B * D * T, N) + mac
            + 2 * R * _mod_down_slots(ctx, B, n_q)
            + R * SLOTS_PER_ADD * B * n_q * N)


def _key_bytes(ctx: dict, n_q: int) -> int:
    """The key rows a switch at n_q reads: the active digits' two rows
    over the n_q + K targets."""
    return (RESIDUE_BYTES * _digits(ctx, n_q) * 2 * (n_q + ctx["K"])
            * ctx["N"])


def least_s(ctx: dict, rec: dict) -> float:
    """The least time of one primitive call ``rec`` (``capture_work``'s
    record: op, B the ciphertexts it holds, n_q its level, and R, J, I,
    terms where the op has them) on the context ``ctx`` (N, L, K, alpha,
    digit_ranges)."""
    op, B, n, N = rec["op"], rec["B"], rec["n_q"], ctx["N"]
    ct = RESIDUE_BYTES * B * n * N             # one polynomial of the batch
    if op == "relinearize":
        return bound_s(3 * ct + _key_bytes(ctx, n) + 2 * ct,
                       _switch_slots(ctx, B, n, 1, False))
    if op == "apply_galois":
        return bound_s(2 * ct + _key_bytes(ctx, n) + INDEX_BYTES * N
                       + 2 * ct, _switch_slots(ctx, B, n, 1, True))
    if op == "rotate_hoisted":
        R = rec["R"]
        return bound_s(2 * ct + R * (_key_bytes(ctx, n) + INDEX_BYTES * N)
                       + R * 2 * ct, _switch_slots(ctx, B, n, R, True))
    if op == "multiply":
        return bound_s(4 * ct + 3 * ct,
                       (4 * SLOTS_PER_EW_MUL + SLOTS_PER_ADD) * B * n * N)
    if op == "multiply_plain":
        return bound_s(2 * ct + RESIDUE_BYTES * n * N + 2 * ct,
                       2 * SLOTS_PER_EW_MUL * B * n * N)
    if op == "rescale":                        # n_q + 1 limbs in, n_q out
        top = RESIDUE_BYTES * B * N
        return bound_s(2 * (ct + top) + 2 * ct,
                       _ntt_slots(2 * B, N) + _ntt_slots(2 * B * n, N)
                       + (2 * SLOTS_PER_EW_MUL + SLOTS_PER_ADD) * 2 * B * n
                       * N)
    if op == "diag_mac":
        k = rec["terms"]
        return bound_s(k * 2 * ct + k * RESIDUE_BYTES * n * N + 2 * ct,
                       2 * B * n * N * (k * SLOTS_PER_PRODUCT
                                        + SLOTS_PER_GROUP_REDC
                                        * -(-k // 4)))
    if op == "mod_matmul":                     # x [J, P, n, N] @ W [J, I]
        J, I, P = rec["J"], rec["I"], rec["P"]
        macs = J * I * P * n * N
        return bound_s(RESIDUE_BYTES * (J + I) * P * n * N
                       + RESIDUE_BYTES * n * J * I,
                       SLOTS_PER_EW_MUL * I * P * n * N,
                       2 * macs * CPMM_DIGITS ** 2)
    if op == "dyadic_sum":     # 3-poly products of X and Y, summed to O
        return bound_s(RESIDUE_BYTES * (2 * rec["X"] + 2 * rec["Y"]
                                        + 3 * rec["O"]),
                       (4 * SLOTS_PER_EW_MUL + SLOTS_PER_ADD) * rec["P"])
    raise ValueError(f"no cost for primitive {op!r}")


def pass_least_s(work: dict, batch: int) -> float:
    """The least time of a pass: the sum over ``work``'s records (each
    with its count), B scaled from the captured batch to ``batch``; the
    matmuls' sizes are the head's and never scale."""
    ctx, scale = work["ctx"], batch / work["batch"]
    total = 0.0
    for rec in work["records"]:
        r = rec if rec["op"] in UNSCALED else dict(rec, B=rec["B"] * scale)
        total += rec["count"] * least_s(ctx, r)
    return total
