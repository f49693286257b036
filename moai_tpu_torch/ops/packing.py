"""Interleaved batch packing + tracing (bias) vector.

Port of ``moai_tpu/ops/packing.py``: a batch of ``num_x`` token matrices
[num_row, num_col] is packed column-wise into ``num_col`` ciphertexts with
slot ``num_x*k + j`` = token k of input j; the num_col ciphertexts are one
batched ciphertext with leading axis num_col.
"""

from __future__ import annotations

import numpy as np

from ..ciphertext import Ciphertext
from ..encrypt import Encryptor


def pack_batch(xs: np.ndarray, num_x: int, num_row: int, slots: int
               ) -> np.ndarray:
    """xs: [num_inputs <= num_x, num_row, num_col] -> slot matrix
    [num_col, slots] with slot[num_x*k + j] = xs[j, k, col]."""
    num_inputs, rows, num_col = xs.shape
    if rows > num_row or num_inputs > num_x or num_x * num_row > slots:
        raise ValueError(f"batch {xs.shape} does not fit num_x={num_x}, "
                         f"num_row={num_row}, slots={slots}")
    out = np.zeros((num_col, slots), dtype=np.float64)
    for j in range(num_inputs):
        idx = num_x * np.arange(rows) + j
        out[:, idx] = xs[j].T
    return out


def unpack_batch(slot_mat: np.ndarray, num_x: int, num_row: int,
                 num_inputs: int) -> np.ndarray:
    """[num_col, slots] -> [num_inputs, num_row, num_col]."""
    num_col = slot_mat.shape[0]
    out = np.empty((num_inputs, num_row, num_col), dtype=slot_mat.dtype)
    for j in range(num_inputs):
        idx = num_x * np.arange(num_row) + j
        out[j] = slot_mat[:, idx].T
    return out


def batch_input(encryptor: Encryptor, xs: np.ndarray, num_x: int,
                num_row: int, scale: float | None = None,
                n_q: int | None = None) -> Ciphertext:
    """Pack + encrypt a batch -> one Ciphertext with leading axis num_col."""
    slots = encryptor.ctx.cfg.slots
    sm = pack_batch(xs, num_x, num_row, slots)
    return encryptor.encrypt(encryptor.encode(sm, scale=scale, n_q=n_q))


def bias_vec(input_lens, num_x: int, num_row: int, slots: int) -> np.ndarray:
    """0/1 tracing vector marking valid-token slots."""
    lens = np.asarray(input_lens)
    mask = np.zeros(slots)
    for j in range(len(lens)):
        k = np.arange(int(lens[j]))
        mask[num_x * k + j] = 1.0
    return mask
