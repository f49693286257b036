"""Exact modular matmul over ciphertext batches.

Port of ``moai_tpu/modmat.py``:

    out[i, p, l, n] = sum_j x[j, p, l, n] * w[j, i]   (mod q_l)

computed exactly by splitting both operands into balanced signed 8-bit
digits, multiplying digits with ``torch._int_mm`` (int8 x int8 -> int32,
exact) and folding each digit-bucket sum back mod q.  Every result is the
canonical residue, so it is bit-identical to the JAX package's.

This is a plain integer matrix product outside any kernel of the JAX
package, so it goes to the library GEMM.  ``torch.matmul`` has no integer
path on CUDA; ``torch._int_mm`` needs more than 16 rows and multiples of 8
in the other two dimensions there, and a column-major right operand, so the
product is oriented as ``w^T [I, J] @ x_l [J, P*N]`` with x_l's digits
stored as [P*N, NDIG*Jp] and I and J zero-padded to fit.  With x's digit
planes ascending and the weights' descending, each digit bucket is one
GEMM over a contiguous column window of both (``bucket_windows``).  Around
the GEMMs, the digit split of a limb and the fold of a bucket dispatch on
the device, as ``mod_arith`` does: on the card the kernels of
``modmat_cuda`` (csrc/modmat.cu), on the CPU their plain versions here.
The loop runs limb by limb, so one limb's digits, one bucket's product and
the accumulator are live at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mod_arith as ma
from . import modmat_cuda

NDIG = modmat_cuda.NDIG   # 8-bit digits covering < 2^32
MAX_J = 8192              # keeps |digit dot| < 2^27 (J * 128 * 128)


def _balanced_digits(x: torch.Tensor) -> list[torch.Tensor]:
    """Integers 0 <= x <= 127 * 0x01010101 (every int32 residue below
    2^30 and more) -> NDIG int8 tensors d_k with x = sum 2^(8k) d_k,
    d_k in [-128, 127]; computed in x's dtype."""
    digs = []
    cur = x
    for _ in range(NDIG):
        d = cur & 0xFF
        carry = d > 127
        d = torch.where(carry, d - 256, d)
        cur = (cur >> 8) + carry
        digs.append(d.to(torch.int8))
    return digs


def host_weight_digits(w_res: np.ndarray) -> np.ndarray:
    """Host: residues [L, J, I] -> balanced int8 digits [NDIG, L, J, I]."""
    digs = np.empty((NDIG,) + w_res.shape, dtype=np.int8)
    cur = w_res.astype(np.int64)
    for k in range(NDIG):
        d = cur & 0xFF
        carry = d > 127
        d = np.where(carry, d - 256, d)
        cur = (cur >> 8) + carry
        digs[k] = d.astype(np.int8)
    if np.any(cur != 0):
        raise ValueError("weight residues must be below 2^32")
    return digs


def host_bucket_consts(qs: list[int]) -> np.ndarray:
    """bucket_mul [2*NDIG-1, L]: 2^(8k) * R mod q, so one Montgomery
    multiply folds bucket k's sum into the accumulator."""
    nb = 2 * NDIG - 1
    cmul = np.empty((nb, len(qs)), dtype=np.int32)
    for li, q in enumerate(qs):
        for k in range(nb):
            cmul[k, li] = (1 << (8 * k)) * (1 << 32) % q
    return cmul


def _pad(n: int, align: int, least: int = 0) -> int:
    return max(least, -(-n // align) * align)


def digit_split_plain(xl: torch.Tensor) -> torch.Tensor:
    """One limb xl [J, P, N] -> int8 [P * N, NDIG * Jp]: row p * N + n
    holds the balanced digit planes 0..NDIG-1 of xl[:, p, n], each
    Jp = modmat_cuda.padded_j(J) wide, zero past J."""
    J, P, N = xl.shape
    Jp = modmat_cuda.padded_j(J)
    xd = torch.zeros((P, N, NDIG, Jp), dtype=torch.int8, device=xl.device)
    for d, dig in enumerate(_balanced_digits(xl)):
        xd[:, :, d, :J] = dig.permute(1, 2, 0)
    return xd.view(P * N, NDIG * Jp)


def bucket_fold_plain(part: torch.Tensor, acc, out: torch.Tensor,
                      c: torch.Tensor, q: torch.Tensor,
                      rinv: torch.Tensor) -> torch.Tensor:
    """out = (acc + (part[:I] mod q) * c * R^-1) mod q, canonical: a digit
    bucket's product part [>= I, P * N] (|part| <= 2^29) folded with
    c = 2^(8k) R mod q into the canonical acc [I, P, N] (None: zero).
    out [I, P, N] may be acc.  Returns out."""
    I, P, N = out.shape
    fold = ma.mont_mul_plain(part[:I].remainder(q), c, q, rinv)
    fold = fold.view(I, P, N)
    return out.copy_(fold if acc is None else ma.add_mod_plain(acc, fold, q))


def digit_split(xl: torch.Tensor) -> torch.Tensor:
    """``digit_split_plain`` on the CPU, the kernel on the card."""
    if xl.is_cuda:
        return modmat_cuda.digit_split(xl)
    return digit_split_plain(xl)


def bucket_fold(part, acc, out, c, q, rinv) -> torch.Tensor:
    """``bucket_fold_plain`` on the CPU, the kernel on the card (which
    needs no rinv)."""
    if out.is_cuda:
        return modmat_cuda.bucket_fold(part, acc, out, c, q)
    return bucket_fold_plain(part, acc, out, c, q, rinv)


def bucket_windows(Jp: int) -> list[tuple[slice, slice]]:
    """For each digit bucket k (0..2 NDIG - 2), the column windows of the
    weight digits (planes in descending order, NDIG - 1 first) and of x's
    digits (ascending) whose product is bucket k's sum over dx of
    W_{k-dx} X_dx: one contiguous run of planes in each."""
    out = []
    for k in range(2 * NDIG - 1):
        lo, hi = max(0, k - NDIG + 1), min(NDIG - 1, k)
        w0 = NDIG - 1 - k + lo
        out.append((slice(w0 * Jp, (w0 + hi - lo + 1) * Jp),
                    slice(lo * Jp, (hi + 1) * Jp)))
    return out


def mod_matmul(x: torch.Tensor, w_digits: torch.Tensor,
               bucket_mul: torch.Tensor, q: torch.Tensor,
               rinv: torch.Tensor) -> torch.Tensor:
    """x: int32 [J, P, L, N] Montgomery; w_digits: int8 [NDIG, L, J, I];
    bucket_mul: int32 [2*NDIG-1, L]; q, rinv: int32 [L].  Returns int32
    [I, P, L, N] Montgomery = sum_j x_j * w_ji mod q_l.

    Per limb: one digit split of x, then per digit bucket one GEMM over a
    column window of each digit matrix (|part| <= 4 J 2^14 <= 2^29, int32)
    and one fold into the canonical accumulator, the last bucket's into
    the output limb, so no sum leaves int32.  One limb's digits, one
    bucket's product and the accumulator are live at a time."""
    J, P, L, N = x.shape
    I = w_digits.shape[-1]
    if J > MAX_J:
        raise ValueError(f"contraction length {J} above {MAX_J}")
    Jp, Ip = modmat_cuda.padded_j(J), _pad(I, 8, least=24)
    # w^T digits, zero-padded, planes descending: [L, Ip, NDIG * Jp]
    wt = torch.zeros((L, Ip, NDIG, Jp), dtype=torch.int8, device=x.device)
    wt[:, :I, :, :J] = w_digits.flip(0).permute(1, 3, 0, 2)
    wt = wt.view(L, Ip, NDIG * Jp)
    out = torch.empty((I, P, L, N), dtype=torch.int32, device=x.device)
    part = torch.empty((Ip, P * N), dtype=torch.int32, device=x.device)
    acc = torch.empty((I, P, N), dtype=torch.int32, device=x.device)
    windows = bucket_windows(Jp)
    for li in range(L):
        xd = digit_split(x[:, :, li, :])               # [P*N, NDIG*Jp]
        for k, (ws, xs) in enumerate(windows):
            # cuBLASLt's int8 product takes a row-major left and a
            # column-major right operand; both windows are read in place
            torch._int_mm(wt[li, :, ws], xd[:, xs].t(), out=part)
            last = k == len(windows) - 1
            bucket_fold(part, None if k == 0 else acc,
                        out[:, :, li, :] if last else acc,
                        bucket_mul[k, li], q[li], rinv[li])
    return out
