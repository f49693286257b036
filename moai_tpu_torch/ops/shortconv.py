"""The causal token-shift convolution over MOAI's interleaved packing.

A column ciphertext holds one channel of a batch of ``num_x`` sequences of
``num_row`` tokens: slot ``num_x*k + j`` is token k of sequence j
(``ops.packing``).  A shift by s tokens toward later tokens is then a
rotation by ``-s*num_x`` slots, and one hoisted decomposition serves every
shift (``Evaluator.rotate_hoisted``).  The rotation wraps tokens
``num_row - s ..`` onto tokens ``0 .. s-1``, so shift s is multiplied by
a 0/1 mask over token rows ``s <= k < len_j``: it zeroes the wrapped tokens
(a full-length sequence's last tokens would otherwise land on its first)
and every padding token, as the mixer's padding mask zeroes them.

The depthwise conv's taps are per channel.  Each shift's mask is encoded
once at the level's top prime and multiplied, on the device, by each
channel's tap rounded at the next prime (``ConvPlaintexts``): one
plaintext product per shift that costs one composite level, as a masked
CPMM does, and whose two rescales return the input's scale exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import mod_arith as ma
from ..ciphertext import Ciphertext, Plaintext
from ..encoder import Encoder
from ..encrypt import encode_ntt
from ..evaluator import Evaluator


def shift_steps(num_x: int, kernel: int) -> list[int]:
    """The rotations of shifts 1 .. kernel-1: slot i of the result holds
    slot i - s*num_x, token k - s of the same sequence."""
    return [-s * num_x for s in range(1, kernel)]


def token_masks(lens, num_x: int, num_row: int, slots: int, kernel: int
                ) -> np.ndarray:
    """[kernel, slots] 0/1: mask s is 1 at token k of sequence j where
    s <= k < lens[j]."""
    out = np.zeros((kernel, slots))
    for j, n in enumerate(np.asarray(lens)):
        for s in range(kernel):
            out[s, num_x * np.arange(s, min(int(n), num_row)) + j] = 1.0
    return out


class ConvPlaintexts:
    """The products of the shift masks and the channels' taps, at level
    ``n_q``: ``data`` [kernel, C, n_q, N], shift s times tap ``taps[:,
    kernel-1-s]`` (the tap of u[t-s]), at scale q_top * q_next of the
    level.  Made once on the device: exact integer products of the masks'
    encodings and the rounded taps."""

    def __init__(self, ev: Evaluator, encoder: Encoder, taps: np.ndarray,
                 masks: np.ndarray, n_q: int):
        ctx = ev.ctx
        kernel = masks.shape[0]
        mask_scale = float(ctx.q_primes[n_q - 1])
        tap_scale = float(ctx.q_primes[n_q - 2])
        enc = encode_ntt(ctx, encoder, masks, mask_scale, n_q)  # [K, n, N]
        q = ev.dev["q"][:n_q].reshape(-1, 1)
        rinv = ev.dev["rinv"][:n_q].reshape(-1, 1)
        taps = np.asarray(taps, np.float64)
        self.data = torch.stack([
            ma.mont_mul(enc[s], ev._const_vec_residues_mont(
                taps[:, kernel - 1 - s], tap_scale, n_q)[:, 0], q, rinv)
            for s in range(kernel)])
        self.scale = mask_scale * tap_scale


def causal_conv(ev: Evaluator, u: Ciphertext, pts: ConvPlaintexts,
                num_x: int) -> Ciphertext:
    """v = sum_s pts[s] * rot(u, -s*num_x) over the column batch u [C, 2,
    n_q, N] at the plaintexts' level: one hoisted rotation call for the
    shifts, the plaintext products, their sum, one composite rescale.  v
    is at u's scale, one level down."""
    kernel = pts.data.shape[0]
    acc = ev.multiply_plain(u, Plaintext(pts.data[0], pts.scale))
    if kernel > 1:
        rot = ev.rotate_hoisted(u, shift_steps(num_x, kernel))
        acc = ev.add(acc, ev.sum_leading(ev.multiply_plain(
            rot, Plaintext(pts.data[1:], pts.scale))))
    return ev.rescale_pair(acc)
