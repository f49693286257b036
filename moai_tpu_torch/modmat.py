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
product is oriented as ``w^T [I, J] @ x_l [J, P*N]`` with x_l stored as
[P*N, J] and I and J zero-padded to fit.  The loop runs
limb by limb, so one limb's digits and one bucket are live at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mod_arith as ma

NDIG = 4          # 8-bit digits covering < 2^32
MAX_J = 8192      # keeps |digit dot| < 2^27 (J * 128 * 128)


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


def _pad8(n: int, least: int = 8) -> int:
    return max(least, -(-n // 8) * 8)


def mod_matmul(x: torch.Tensor, w_digits: torch.Tensor,
               bucket_mul: torch.Tensor, q: torch.Tensor,
               rinv: torch.Tensor) -> torch.Tensor:
    """x: int32 [J, P, L, N] Montgomery; w_digits: int8 [NDIG, L, J, I];
    bucket_mul: int32 [2*NDIG-1, L]; q, rinv: int32 [L].  Returns int32
    [I, P, L, N] Montgomery = sum_j x_j * w_ji mod q_l.  Each digit
    bucket's product (|part| < 2^29, int32) is reduced, folded by one
    Montgomery multiply, and added to the canonical accumulator with
    ``add_mod``, so no sum leaves int32."""
    J, P, L, N = x.shape
    I = w_digits.shape[-1]
    if J > MAX_J:
        raise ValueError(f"contraction length {J} above {MAX_J}")
    Jp, Ip = _pad8(J), _pad8(I, least=24)
    # w^T digits, zero-padded: [NDIG, L, Ip, Jp]
    wt = torch.zeros((NDIG, L, Ip, Jp), dtype=torch.int8, device=x.device)
    wt[:, :, :I, :J] = w_digits.transpose(-1, -2)
    out = torch.empty((I, P, L, N), dtype=torch.int32, device=x.device)
    xl = torch.zeros((P * N, Jp), dtype=torch.int32, device=x.device)
    for li in range(L):
        xl[:, :J] = x[:, :, li, :].reshape(J, P * N).t()
        xd = _balanced_digits(xl)                      # NDIG x [P*N, Jp]
        ql, rl = q[li], rinv[li]
        acc = None
        for k in range(2 * NDIG - 1):
            part = None
            for dx in range(max(0, k - NDIG + 1), min(NDIG, k + 1)):
                # cuBLASLt's int8 product takes a row-major left and a
                # column-major right operand
                term = torch._int_mm(wt[k - dx, li], xd[dx].t())  # [Ip, P*N]
                part = term if part is None else part.add_(term)
            # |part| < 2^29: reduce, then fold with 2^(8k) R
            fold = ma.mont_mul(part[:I].remainder_(ql), bucket_mul[k, li],
                               ql, rl)
            acc = fold if acc is None else ma.add_mod(acc, fold, ql)
        out[:, :, li, :] = acc.reshape(I, P, N)
    return out
