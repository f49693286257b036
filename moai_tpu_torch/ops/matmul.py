"""Encrypted matrix multiplication: CPMM and CCMM.

Port of ``moai_tpu/ops/matmul.py``:
- CPMM: a col-packed ciphertext batch X times a plaintext W, one exact
  integer matmul per limb (``modmat.mod_matmul``), no rotations.
- ``ccmm_col_to_diag``: col-packed X times col-packed W^T -> diagonal-packed
  X W^T, double baby-step/giant-step over hoisted rotations.
- ``ccmm_diag_to_col``: diagonal-packed A times col-packed V -> col-packed
  A V, baby-step/giant-step.

Each matmul consumes one composite level.  The sums over a batch axis
accumulate canonical int32 residues in int64 (``torch.sum``'s result
type) and reduce once, back to int32, which gives the same canonical
residue as the JAX package's pairwise ``add_mod`` tree.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import mod_arith as ma
from ..ciphertext import Ciphertext, Plaintext
from ..encoder import Encoder
from ..encrypt import encode_ntt, rounded_to_ntt
from ..evaluator import Evaluator
from ..modmat import mod_matmul, host_weight_digits, host_bucket_consts


def _bsgs_split(m: int) -> tuple[int, int]:
    g = int(np.ceil(np.sqrt(m)))
    return g, int(np.ceil(m / g))


# bound on the rotated operands ccmm_col_to_diag holds per column chunk
ROT_OPERAND_BYTES = 2 << 30


def col_chunk_for(ctx, n_q: int, num_row: int) -> int:
    """Columns per ccmm_col_to_diag chunk: the g+b rotated copies of a
    chunk, [g+b, chunk, 2, n_q, N] int32, stay within ROT_OPERAND_BYTES."""
    g, b = _bsgs_split(num_row)
    per_col = (g + b) * 2 * n_q * ctx.cfg.N * 4
    return max(1, ROT_OPERAND_BYTES // per_col)


def _bsgs_steps(num_x: int, num_row: int) -> list[int]:
    """Baby steps s*num_x (s < g) and giant steps +-g*bi*num_x (bi < b)."""
    g, b = _bsgs_split(num_row)
    steps = {s * num_x for s in range(1, g)}
    for bi in range(1, b):
        steps.add(g * bi * num_x)
        steps.add(-g * bi * num_x)
    return sorted(steps)


def ccmm_col_steps(num_x: int, num_row: int) -> list[int]:
    """Rotation steps needed by ccmm_col_to_diag (galois key planning)."""
    return _bsgs_steps(num_x, num_row)


def ccmm_diag_steps(num_x: int, num_row: int) -> list[int]:
    """Rotation steps needed by ccmm_diag_to_col."""
    return _bsgs_steps(num_x, num_row)


def _dyadic_sum(x0, x1, y0, y1, dim: int, q, rinv) -> torch.Tensor:
    """sum over ``dim`` of the 3-poly products (x0 y0, x0 y1 + x1 y0,
    x1 y1), broadcasting x against y; one component is live at a time.
    Returns int32 [..., 3, L, N] with ``dim`` removed; each sum is taken
    in int64 and reduced."""
    def s(a, b):
        return ma.mont_mul(a, b, q, rinv).sum(dim)        # int64

    def r(t):
        return t.remainder_(q).to(torch.int32)
    c1 = s(x0, y1)
    c1 = r(c1.add_(s(x1, y0)))
    return torch.stack([r(s(x0, y0)), c1, r(s(x1, y1))], dim=-3)


class CPMM:
    """Ct x pt matmul: out[i] = sum_j x[j] * W[j, i] (+ bias).

    W: [J, I] float weights.  ``n_q`` is the level the input arrives at.
    With ``mask`` (the tracing vector over slots) the weights are encoded at
    the top single prime and the mask at the following prime, so the masked
    product still costs exactly one composite level.

    Output columns are independent, so ``cols`` (a slice of I) computes
    only those columns, with the same residues.  ``product`` over a slice
    of the rows J (the input holding only those ciphertexts) gives partial
    sums; their modular sum, passed to ``finish``, is the full product,
    with the same residues (the rescale of a sum is not the sum of
    rescales, so partial sums meet before ``finish``).  Limbs are
    independent too: ``product`` over a limb window gives those limbs of
    the product (``parallel.sharding.cpmm_sharded`` runs both splits).
    """

    def __init__(self, ev: Evaluator, encoder: Encoder, W: np.ndarray,
                 n_q: int, bias: np.ndarray | None = None,
                 mask: np.ndarray | None = None):
        self.ev = ev
        ctx = ev.ctx
        self.n_q = n_q
        qs = ctx.q_primes[:n_q]
        self.out_dim = W.shape[1]
        if mask is None:
            w_scale = float(qs[-1]) * float(qs[-2])
            self.mask_pt = None
        else:
            w_scale = float(qs[-1])
            mask_scale = float(qs[-2])
            self.mask_pt = Plaintext(
                encode_ntt(ctx, encoder, mask, mask_scale, n_q), mask_scale)
        self.w_scale = w_scale
        wv = np.round(np.asarray(W, np.float64) * w_scale)
        if np.abs(wv).max() >= 2 ** 62:
            raise ValueError("weights too large for the level's scale")
        wi = wv.astype(np.int64)
        res = np.stack([wi % q for q in qs])                 # [n_q, J, I]
        self.w_digits = torch.from_numpy(host_weight_digits(res)).to(
            ev.device)
        self.bucket_mul = torch.from_numpy(host_bucket_consts(qs)).to(
            ev.device)
        # the weight digits and the level's q and R^-1 by device (moved to a
        # mesh position's device at first use)
        self._tables = {ev.device: (self.w_digits, self.bucket_mul,
                                    ev.dev["q"][:n_q], ev.dev["rinv"][:n_q])}
        self.bias = bias
        # the bias plaintext's rounded coefficients [I, N] (host), encoded
        # to residues per call: [I, n_q, N] residues of a wide layer would
        # hold gigabytes on the card
        self._bias_rounded = None
        self._bias_scale = None
        self.encoder = encoder
        self.bias_mask = mask

    def __call__(self, x: Ciphertext, rescale: bool = True,
                 cols: slice | None = None) -> Ciphertext:
        """x: Ciphertext with leading batch axis J.  Output batch axis I
        (the columns ``cols`` of W only, when given)."""
        return self.finish(self.product(x, cols=cols), x.scale,
                           rescale=rescale, cols=cols)

    def product(self, x: Ciphertext, rows: slice | None = None,
                cols: slice | None = None,
                window: tuple | None = None) -> torch.Tensor:
        """sum_j x[j] W[j, i] mod q over the rows ``rows`` of W (x holds
        just those ciphertexts) and its columns ``cols``: [I, P, n_q, N].
        With ``window`` (lo, hi), x holds the level's limbs [lo, hi) only
        (a limb shard, on any device) and the product is those limbs'."""
        lo, hi = window or (0, self.n_q)
        if x.n_q != hi - lo or hi > max(lo, self.n_q):     # may be empty
            raise ValueError(f"CPMM built for n_q={self.n_q}, got {x.n_q}"
                             + (f" limbs for the window {window}"
                                if window else ""))
        dev = x.data.device
        if dev not in self._tables:
            self._tables[dev] = tuple(t.to(dev)
                                      for t in self._tables[self.ev.device])
        w, bucket_mul, q, rinv = self._tables[dev]
        w = w[:, lo:hi]
        if rows is not None:
            w = w[:, :, rows]
        if cols is not None:
            w = w[..., cols]
        return mod_matmul(x.data, w, bucket_mul[:, lo:hi], q[lo:hi],
                          rinv[lo:hi])

    def finish(self, data: torch.Tensor, x_scale: float, rescale: bool = True,
               cols: slice | None = None) -> Ciphertext:
        """Mask, rescale and bias of a product from ``product``."""
        return self.finish_ct(self.ev, Ciphertext(
            data, x_scale * self.w_scale, True), rescale, cols)

    def finish_ct(self, ev, ct, rescale: bool = True,
                  cols: slice | None = None):
        """``finish`` of the product ciphertext ``ct`` (at x_scale *
        w_scale) over ``ev``: an Evaluator, or a ShardedEvaluator with
        ``ct`` sharded, which places the mask and the bias like ``ct``."""
        if self.mask_pt is not None:
            ct = ev.multiply_plain(ct, self.mask_pt)
        if rescale:
            ct = ev.rescale(ev.rescale(ct))
            if self.bias is not None:
                ct = ev.add_plain(ct, self._bias(ct, cols))
        return ct

    def _bias(self, ct: Ciphertext, cols: slice | None) -> Plaintext:
        if self._bias_scale != ct.scale:
            slots = self.ev.ctx.cfg.slots
            vecs = np.broadcast_to(np.asarray(self.bias)[:, None],
                                   (self.out_dim, slots)).copy()
            if self.bias_mask is not None:
                vecs *= self.bias_mask[None, :]
            self._bias_rounded = self.encoder.encode_coeffs(vecs, ct.scale)
            self._bias_scale = ct.scale
        rounded = self._bias_rounded if cols is None else \
            self._bias_rounded[cols]
        return Plaintext(rounded_to_ntt(self.ev.ctx, self.encoder, rounded,
                                        ct.n_q), ct.scale)


def ccmm_col_to_diag(ev: Evaluator, x: Ciphertext, w: Ciphertext,
                     num_x: int, num_row: int,
                     col_chunk: int | None = None) -> Ciphertext:
    """Col-packed X [C cts] x col-packed W [C cts] -> diagonal-packed X W^T
    [num_row cts]: out[i] = sum_j X_j * rot(W_j, i*num_x).

    Double BSGS: with i = s + g*bi,

        out[s+g*bi] = rot( sum_j rot(X_j, -g*bi*num_x) * rot(W_j, s*num_x),
                           g*bi*num_x )

    so one hoisted sweep of g-1 baby rotations of W and one of b-1 giant
    rotations of X (both over the column batch), the dyadic products, one
    batched relinearization and b-1 giant output rotations.

    ``col_chunk``: process the column axis in chunks of this size, which
    bounds the [g+b, chunk, 2, L, N] rotated operands; the partial products
    accumulate across chunks.
    """
    if x.n_q != w.n_q:
        raise ValueError(f"ccmm_col_to_diag level mismatch: X at n_q={x.n_q}"
                         f", W at n_q={w.n_q}")
    C = x.data.shape[0]
    col_chunk = col_chunk or C
    q = ev.dev["q"][:x.n_q].reshape(-1, 1)
    acc = None                      # [b, g, 3, L, N] group partial products
    for lo in range(0, C, col_chunk):
        part = ccmm_col_to_diag_partial(
            ev, x.with_data(x.data[lo:lo + col_chunk]),
            w.with_data(w.data[lo:lo + col_chunk]), num_x, num_row)
        acc = part if acc is None else ma.add_mod(acc, part, q)
    return ccmm_col_to_diag_finish(ev, acc, x.scale * w.scale, num_x,
                                   num_row)


# rotations per hoisted MAC in ccmm_col_to_diag_partial
CCMM_ROT_CHUNK = 4


def ccmm_col_rotations(num_x: int, num_row: int) -> tuple[list, list]:
    """The double BSGS's rotation steps: W's baby steps s*num_x (0 < s <
    g) and X's giant steps -g*bi*num_x (0 < bi < b)."""
    g, b = _bsgs_split(num_row)
    return ([s * num_x for s in range(1, g)],
            [-gi * g * num_x for gi in range(1, b)])


def ccmm_col_to_diag_partial(ev: Evaluator, x: Ciphertext, w: Ciphertext,
                             num_x: int, num_row: int) -> torch.Tensor:
    """One column chunk's double-BSGS partial products [b, g, 3, L, N]
    (3-poly, before relinearization).  Chunks add."""
    baby, giant = ccmm_col_rotations(num_x, num_row)
    wb = w.data[None]                                  # [g, c, 2, L, N]
    if baby:
        wb = torch.cat([wb, ev.rotate_hoisted(
            w, baby, chunk=CCMM_ROT_CHUNK).data])
    xg = x.data[None]                                  # [b, c, 2, L, N]
    if giant:
        xg = torch.cat([xg, ev.rotate_hoisted(
            x, giant, chunk=CCMM_ROT_CHUNK).data])
    return ccmm_col_products(xg, wb, ev.dev["q"][:x.n_q].reshape(-1, 1),
                             ev.dev["rinv"][:x.n_q].reshape(-1, 1))


def ccmm_col_products(xg, wb, q, rinv) -> torch.Tensor:
    """The partial products of the giant-rotated X [b, c, 2, n, N] and the
    baby-rotated W [g, c, 2, n, N] modulo q, rinv [n, 1], per giant group
    summed over the column axis c -> [b, g, 3, n, N]."""
    w0, w1 = wb[:, :, 0], wb[:, :, 1]                  # [g, c, n, N]
    return torch.stack([
        _dyadic_sum(xg[bi, None, :, 0], xg[bi, None, :, 1], w0, w1, 1, q,
                    rinv) for bi in range(xg.shape[0])])


def ccmm_col_to_diag_finish(ev: Evaluator, acc, prod_scale: float,
                            num_x: int, num_row: int) -> Ciphertext:
    """Relinearize the accumulated [b, g, 3, L, N] groups, apply the giant
    output rotations, interleave diagonals, rescale."""
    m = num_row
    g, b = _bsgs_split(m)
    rel = ev.relinearize(Ciphertext(acc, prod_scale, True))
    diags = []
    for bi in range(b):
        ng = min(g, m - bi * g)
        grp = Ciphertext(rel.data[bi, :ng], rel.scale, True)
        if bi:
            grp = ev.rotate(grp, g * bi * num_x)       # giant output rotation
        diags.append(grp.data)
    out = Ciphertext(torch.cat(diags), rel.scale, True)
    return ev.rescale(ev.rescale(out))


# rotations of V per hoisted MAC in ccmm_diag_to_col
DIAG_ROT_CHUNK = 4


def ccmm_diag_to_col(ev: Evaluator, x: Ciphertext, v: Ciphertext,
                     num_x: int, num_row: int,
                     rot_chunk: int = DIAG_ROT_CHUNK) -> Ciphertext:
    """Diagonal-packed A [num_row cts, diag d slot k = A[k, k+d]] x
    col-packed V [dv cts] -> col-packed A V [dv cts], baby-step/giant-step:

        AV_col_c = sum_b rot( sum_s rot(diag_{g b+s}, -g b num_x)
                              (*) rot(V_c, s num_x),  g b num_x )
    """
    m = num_row
    if x.data.shape[0] != m:
        raise ValueError(f"{x.data.shape[0]} diagonals for num_row={m}")
    if x.n_q != v.n_q:
        raise ValueError(f"ccmm_diag_to_col level mismatch: A at n_q={x.n_q}"
                         f", V at n_q={v.n_q}")
    g, b = _bsgs_split(m)
    q = ev.dev["q"][:x.n_q].reshape(-1, 1)
    rinv = ev.dev["rinv"][:x.n_q].reshape(-1, 1)
    vb = v.data[None]                                  # [g, dv, 2, L, N]
    if g > 1:
        vb = torch.cat([vb, ev.rotate_hoisted(
            v, [s * num_x for s in range(1, g)], chunk=rot_chunk).data])
    total = None
    prod_scale = x.scale * v.scale
    for bi in range(b):
        lo, hi = bi * g, min((bi + 1) * g, m)
        grp = x.with_data(x.data[lo:hi])
        if bi:
            grp = ev.rotate(grp, -g * bi * num_x)      # pre-rotate the group
        ng = hi - lo
        p_sum = _dyadic_sum(grp.data[:, None, 0], grp.data[:, None, 1],
                            vb[:ng, :, 0], vb[:ng, :, 1], 0, q, rinv)
        # relinearize and giant-rotate per group
        part = ev.relinearize(Ciphertext(p_sum, prod_scale, True))
        if bi:
            part = ev.rotate(part, g * bi * num_x)     # giant step
        total = part if total is None else \
            part.with_data(ma.add_mod(total.data, part.data, q))
    return ev.rescale(ev.rescale(total))
