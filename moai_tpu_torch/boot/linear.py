"""Homomorphic linear transforms: BSGS diagonal apply + CoeffToSlot /
SlotToCoeff matrices.

Port of ``moai_tpu/boot/linear.py``.  The host functions that build the
diagonals (the canonical-embedding matrix, its radix-2 butterfly factors,
their inverses, composition and grouping) are numpy and copied verbatim.
``apply_diagonals`` is the same BSGS schedule in eager PyTorch: one hoisted
decomposition for the baby rotations, each giant step's products and sum
in one ``mod_arith.diag_mac`` (a kernel on the card), giant rotations on
partial sums, one composite-level rescale at the end.

Plaintext diagonals.  The JAX package encodes each diagonal into NTT
residues where it is used (as jit constants, or collected once by
``Bootstrapper.collect_lt``).  Here ``encode_diagonals`` rounds each
pre-rotated diagonal's coefficients once on the host and keeps them on the
device as one int64 vector [N] (signed coefficients, not residues); each
use turns a giant step's diagonals
into residues at the ciphertext's level and runs one forward NTT over them
(on a CUDA tensor, the hand-written kernel).  A coefficient vector reaching
2^62 keeps its exact standard residues over the whole chain instead (the
encoder's big-int branch).  The residues are the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import mod_arith as ma
from ..ciphertext import Ciphertext
from ..encoder import Encoder
from ..evaluator import Evaluator
from ..keys import residues_to_ntt


def matrix_diagonals(M: np.ndarray) -> dict[int, np.ndarray]:
    """Dense [n, n] complex matrix -> {d: diag_d[n]} with
    (M v)_i = sum_d diag_d[i] * v[(i+d) mod n]; zero diagonals dropped."""
    n = M.shape[0]
    out = {}
    idx = np.arange(n)
    for d in range(n):
        diag = M[idx, (idx + d) % n]
        if np.max(np.abs(diag)) > 1e-14:
            out[d] = diag
    return out


def bsgs_steps(diag_indices, n: int) -> list[int]:
    """Rotation steps the BSGS apply needs for these diagonals."""
    g = max(1, int(np.ceil(np.sqrt(len(diag_indices)))))
    babies = set()
    giants = set()
    for d in diag_indices:
        babies.add(d % g)
        giants.add(d - d % g)
    steps = {s for s in babies if s} | {s for s in giants if s}
    return sorted(steps)


def _giant_groups(diags: dict) -> tuple[int, dict[int, list[int]]]:
    """Baby-step count g and the diagonals of each giant step gi."""
    idxs = sorted(diags.keys())
    g = max(1, int(np.ceil(np.sqrt(len(idxs)))))
    groups: dict[int, list[int]] = {}
    for d in idxs:
        groups.setdefault(d - d % g, []).append(d)
    return g, groups


def encode_diagonals(ctx, encoder: Encoder, diags: dict, scale: float,
                     alpha: float | None = None) -> dict:
    """Round every diagonal of one level, pre-rotated by -gi for its giant
    step (Halevi-Shoup) and times ``alpha`` when given, at ``scale``:
    {(gi, d): int64 coefficients [N], or int32 standard residues [L, N]
    where a coefficient reaches 2^62}, on the context's device."""
    _, groups = _giant_groups(diags)
    out = {}
    for gi, ds in groups.items():
        for d in ds:
            v = diags[d] if alpha is None else diags[d] * alpha
            rounded = encoder.encode_coeffs(np.roll(v, gi), scale)
            if np.abs(rounded).max() < 2 ** 62:
                host = rounded.astype(np.int64)
            else:
                host = encoder.residues(rounded, ctx.L).view(np.int32)
            out[(gi, d)] = torch.from_numpy(host).to(ctx.device)
    return out


def diagonal_plaintexts(ctx, stored: list, n_q: int, lo: int = 0
                        ) -> torch.Tensor:
    """Encoded diagonals (``encode_diagonals``) at level n_q, limbs [lo,
    n_q): residues, Montgomery form and one batched forward NTT ->
    [len(stored), n_q - lo, N]."""
    q = ctx.dev["q"][lo:n_q].reshape(-1, 1)
    res = torch.stack([s.remainder(q).to(torch.int32) if s.dim() == 1
                       else s[lo:n_q] for s in stored])
    return residues_to_ntt(ctx, res, lo, n_q)


def apply_diagonals(ev: Evaluator, encoder: Encoder, ct: Ciphertext,
                    diags: dict[int, np.ndarray],
                    encoded: dict | None = None) -> Ciphertext:
    """Homomorphic M @ slots(ct) via BSGS over the nonzero diagonals.

    rot(v, s) here is the slot rotation (i -> v[(i+s) mod n]), matching
    Evaluator.rotate.  Baby steps use one hoisted decomposition; giant
    steps rotate the combined partial sums, with the plaintext diagonals
    pre-rotated on host (Halevi-Shoup) and encoded at the pair scale of
    ct's level, so the rescale restores ct's scale.  ``encoded`` is this
    level's ``encode_diagonals`` at that scale; without it every diagonal
    is encoded here.  Consumes one composite level."""
    g, groups = _giant_groups(diags)
    scale = ev.level_pair_scale(ct.n_q)
    if encoded is None:
        encoded = encode_diagonals(ev.ctx, encoder, diags, scale)
    q = ev._q(ct.n_q)
    baby_set = sorted({d % g for d in diags})
    rot = {0: ct}
    nonzero = [s for s in baby_set if s]
    if nonzero:
        hoisted = ev.rotate_hoisted(ct, nonzero)
        for i, s in enumerate(nonzero):
            rot[s] = Ciphertext(hoisted.data[i], hoisted.scale, True)
        del hoisted
    total = None
    for gi, ds in sorted(groups.items()):
        pts = diagonal_plaintexts(ev.ctx, [encoded[(gi, d)] for d in ds],
                                  ct.n_q)
        # sum_d multiply_plain(rot[d % g], pt_d): one diag_mac
        part = Ciphertext(ma.diag_mac([rot[d % g].data for d in ds], pts, q,
                                      ev._rinv(ct.n_q)),
                          ct.scale * scale, True)
        if gi:
            part = ev.rotate(part, gi)
        total = part if total is None else \
            Ciphertext(ma.add_mod(total.data, part.data, q), part.scale, True)
    del rot
    return ev.rescale_pair(total)


# --------------------------------------------------------------------------
# CoeffToSlot / SlotToCoeff matrices from the canonical embedding
# --------------------------------------------------------------------------

def embedding_matrix(encoder: Encoder) -> np.ndarray:
    """A [n, n] with A[j, k] = zeta^(rot_j * k):  slots(c) = A u for a real
    coefficient vector c = (c_lo | c_hi) packed as u = c_lo + i*c_hi.

    (Because rot_j = 5^j ≡ 1 mod 4, the high-column block is exactly
    i * A_lo, so the N-coefficient embedding collapses to one invertible
    n x n complex map; and A A^H = n I — the rows are orthogonal since
    sum_k zeta^((r_j - r_j')k) telescopes to 0 for j != j' — so the
    inverse is A^H / n, never a numerical inversion.)
    """
    n = encoder.slots
    N = encoder.N
    expo = np.outer(encoder.rot_group % (2 * N), np.arange(n)) % (2 * N)
    return np.exp(1j * np.pi * expo / N)


def c2s_matrix(encoder: Encoder) -> np.ndarray:
    """CoeffToSlot: u = (A^H / n) @ slots — slots become c_lo + i*c_hi."""
    A = embedding_matrix(encoder)
    return A.conj().T / encoder.slots


def s2c_matrix(encoder: Encoder) -> np.ndarray:
    """SlotToCoeff: slots = A @ u."""
    return embedding_matrix(encoder)


# --------------------------------------------------------------------------
# Radix-2 factorization (memory-feasible at full scale)
#
# Dense C2S/S2C needs n diagonal plaintexts — infeasible at n = 2^15.
# The embedding matrix factors by the classic even/odd split: with
# exps[j] = 5^j mod 2N,  exps[j + m/2] = (N+1) * exps[j], so the twiddle of
# the upper half is the negation of the lower's and each split is one
# 2-diagonal butterfly in slot space.  The even/odd column permutations
# accumulate to a bit-reversal Pi that is NEVER applied: CoeffToSlot
# produces coefficients in bit-reversed order, EvalMod is slot-pointwise,
# and SlotToCoeff (same recursion) consumes the same order, so Pi cancels
# inside the bootstrap.
# --------------------------------------------------------------------------

def _s2c_butterflies(encoder: Encoder) -> list[dict[int, np.ndarray]]:
    """Butterfly factors in MATRIX order:  A = B_0 @ B_1 @ ... @ B_{k-1}
    (up to the column bit-reversal Pi, never materialized); each B is
    {diag_index: vec[n]} with exactly 2 diagonals {0, block/2}."""
    n = encoder.slots
    two_n = 2 * encoder.N
    levels = []
    exps = [np.array(encoder.rot_group % two_n, dtype=np.int64)]
    m = n
    while m > 1:
        m2 = m // 2
        d0 = np.zeros(n, complex)
        dp = np.zeros(n, complex)            # diagonal +m2 (lower rows)
        dm = np.zeros(n, complex)            # diagonal -m2 (upper rows)
        new_exps = []
        for b, e in enumerate(exps):
            base = b * m
            w = np.exp(1j * np.pi * (e[:m2] % two_n) / encoder.N)
            d0[base: base + m2] = 1.0        # B[j, j] = 1
            d0[base + m2: base + m] = -w     # B[j+m2, j+m2] = -w_j
            dp[base: base + m2] = w          # B[j, j+m2] = w_j
            dm[base + m2: base + m] = 1.0    # B[j+m2, j] = 1
            half = 2 * e[:m2] % two_n
            new_exps.extend([half, half.copy()])
        lev = {0: d0}
        if m2 % n == (n - m2) % n:           # first level: +m2 == -m2 mod n
            lev[m2 % n] = dp + dm
        else:
            lev[m2] = dp
            lev[n - m2] = dm
        levels.append(lev)
        exps = new_exps
        m //= 2
    return levels


def _invert_butterfly(lev: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
    """Inverse of one butterfly level (again 3 diagonals {0, +-m2}):
    per block pair, [[1, w],[1, -w]]^-1 = 0.5*[[1, 1],[1/w, -1/w]]."""
    n = len(lev[0])
    m2 = min(d for d in lev if d != 0)
    w_vec = lev[m2]                           # w on lower rows of diag +m2
    inv0 = np.zeros(n, complex)
    invp = np.zeros(n, complex)               # diag +m2 of the inverse
    invm = np.zeros(n, complex)               # diag -m2 of the inverse
    for base in range(0, n, 2 * m2):
        w = w_vec[base: base + m2]
        inv0[base: base + m2] = 0.5           # [j, j]
        invp[base: base + m2] = 0.5           # [j, j+m2]
        invm[base + m2: base + 2 * m2] = 0.5 / w      # [j+m2, j]
        inv0[base + m2: base + 2 * m2] = -0.5 / w     # [j+m2, j+m2]
    out = {0: inv0}
    if m2 % n == (n - m2) % n:
        out[m2] = invp + invm
    else:
        out[m2] = invp
        out[n - m2] = invm
    return out


def s2c_apply_levels(encoder: Encoder) -> list[dict[int, np.ndarray]]:
    """SlotToCoeff factor levels in APPLICATION order (apply list[0]
    first to the ciphertext):  slots = B_0 ... B_{k-1} u_bitrev, so the
    rightmost factor B_{k-1} is applied first."""
    return list(reversed(_s2c_butterflies(encoder)))


def c2s_apply_levels(encoder: Encoder) -> list[dict[int, np.ndarray]]:
    """CoeffToSlot factor levels in APPLICATION order:
    u_bitrev = B_{k-1}^-1 ... B_0^-1 slots — apply B_0^-1 first."""
    return [_invert_butterfly(l) for l in _s2c_butterflies(encoder)]


def compose_diagonals(A: dict, B: dict, n: int) -> dict:
    """Diagonal form of A @ B: (A@B)[i, i+da+db] += A[i,i+da]*B[i+da, ...]."""
    out: dict[int, np.ndarray] = {}
    for da, va in A.items():
        for db, vb in B.items():
            d = (da + db) % n
            term = va * np.roll(vb, -da)
            if d in out:
                out[d] = out[d] + term
            else:
                out[d] = term.copy()
    return {d: v for d, v in out.items() if np.max(np.abs(v)) > 1e-14}


def group_apply_levels(levels: list[dict[int, np.ndarray]], group: int
                       ) -> list[dict[int, np.ndarray]]:
    """Merge ``group`` consecutive APPLICATION-order levels into one
    multi-diagonal level (depth vs diagonal-count tradeoff).  Application
    order means later levels multiply from the LEFT."""
    n = len(next(iter(levels[0].values())))
    grouped = []
    for i in range(0, len(levels), group):
        acc = levels[i]
        for j in range(i + 1, min(i + group, len(levels))):
            acc = compose_diagonals(levels[j], acc, n)
        grouped.append(acc)
    return grouped
