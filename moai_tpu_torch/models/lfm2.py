"""LFM2's gated short-convolution mixer (HF ``Lfm2ShortConv``) over CKKS.

The token mixer of LFM2's conv layers (``models.lfm2_reference`` holds its
equations and its plain version), on one chip's channel share of a layer
split by channel: in_proj column-parallel, the gates and the depthwise
causal conv per channel, out_proj row-parallel, so the share computes its
channels' partial sum of y, which an all-reduce over the shares would
complete (on one chip there is none to make).  The input is the whole
hidden state h, ``hidden_size`` column ciphertexts in MOAI's interleaved
packing (``ops.packing``: ``num_x`` sequences of ``num_row`` tokens).

Every step is linear or a product, so the circuit is the mixer itself, no
polynomial stands in for anything.  Five composite levels:

    in_proj    CPMM of h by the held rows of B, C and x        1 level
    u = B*x    multiply_relin + rescale                         1 level
    v          causal shift conv (``ops.shortconv``): hoisted
               rotations, mask-and-tap plaintexts               1 level
    C*v        multiply_relin + rescale (C dropped to v's level) 1 level
    out_proj   CPMM.product over the held rows + finish         1 level

Spans: ``lfm2_conv`` (the pass), ``lfm2.in_proj``, ``lfm2.gate`` (each
product), ``lfm2.shift``, ``lfm2.out_proj``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ciphertext import Ciphertext
from ..encoder import Encoder
from ..evaluator import Evaluator
from ..ops.matmul import CPMM
from ..ops.shortconv import ConvPlaintexts, causal_conv, token_masks
from ..utils import debug

LEVELS = 5          # composite levels the mixer consumes


@dataclasses.dataclass(frozen=True)
class Lfm2ConvDims:
    """The mixer's published widths, the channels this chip holds and the
    packing."""
    hidden_size: int = 2048
    conv_L_cache: int = 3
    channels: tuple = (0, 256)      # held channel range [lo, hi)
    num_x: int = 256
    num_row: int = 128

    @property
    def held(self) -> int:
        return self.channels[1] - self.channels[0]

    def __post_init__(self):
        lo, hi = self.channels
        if not 0 <= lo < hi <= self.hidden_size:
            raise ValueError(f"held channels {self.channels} outside "
                             f"[0, {self.hidden_size})")


class EncryptedShortConv:
    """The share's mixer, its input h arriving at level ``n_q``.

    ``weights`` holds ``in_proj`` [3H, H], ``conv`` [H, L] and
    ``out_proj`` [H, H] (the nn layouts, ``lfm2_reference.weights``);
    ``lens`` the sequences' lengths, whose padding tokens the conv's masks
    zero (so y is zero there)."""

    def __init__(self, ev: Evaluator, encoder: Encoder, dims: Lfm2ConvDims,
                 weights: dict, lens, n_q: int):
        ctx = ev.ctx
        if n_q - 2 * LEVELS < ctx.n_q0:
            raise ValueError(f"chain too short: the mixer needs {LEVELS} "
                             f"levels above q0, h arrives at {n_q} limbs")
        self.ev, self.dims = ev, dims
        lo, hi = dims.channels
        H = dims.hidden_size
        # in_proj column-parallel: the rows of B, C and x for the held
        # channels, in that order
        rows = np.concatenate([np.arange(lo, hi) + k * H for k in range(3)])
        self.in_mm = CPMM(ev, encoder,
                          np.asarray(weights["in_proj"], np.float64)[rows].T,
                          n_q)
        # a composite level is two limbs: u arrives at the conv after
        # in_proj and B*x, C*v at out_proj after the conv and C*v
        self.pts = ConvPlaintexts(
            ev, encoder, np.asarray(weights["conv"], np.float64)[lo:hi],
            token_masks(lens, dims.num_x, dims.num_row, ctx.cfg.slots,
                        dims.conv_L_cache), n_q - 4)
        # out_proj row-parallel: the full W_out^T [H_in, H_out], of which
        # the pass multiplies the held input channels' rows
        self.out_mm = CPMM(ev, encoder,
                           np.asarray(weights["out_proj"], np.float64).T,
                           n_q - 8)

    @debug.spanned("lfm2.in_proj")
    def in_proj(self, x: Ciphertext) -> Ciphertext:
        """h [H cts] -> B, C and x of the held channels [3 * held cts]."""
        return self.in_mm(x)

    @debug.spanned("lfm2.gate")
    def gate(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """a * b, one level (the deeper operand dropped to the other's)."""
        return self.ev.mul_relin_rescale(a, b)

    @debug.spanned("lfm2.shift")
    def shift(self, u: Ciphertext) -> Ciphertext:
        return causal_conv(self.ev, u, self.pts, self.dims.num_x)

    @debug.spanned("lfm2.out_proj")
    def out_proj(self, cv: Ciphertext) -> Ciphertext:
        """C*v [held cts] -> the share's partial y [H cts]."""
        rows = slice(*self.dims.channels)
        return self.out_mm.finish(self.out_mm.product(cv, rows=rows),
                                  cv.scale)

    @debug.spanned("lfm2_conv")
    def __call__(self, x: Ciphertext) -> Ciphertext:
        c = self.dims.held
        bcx = self.in_proj(x)
        u = self.gate(bcx.with_data(bcx.data[:c]),
                      bcx.with_data(bcx.data[2 * c:]))
        # C at v's level, copied so that B and x are freed
        gate_c = bcx.with_data(
            bcx.data[c:2 * c, :, :bcx.n_q - 4].contiguous())
        del bcx
        v = self.shift(u)
        del u
        return self.out_proj(self.gate(gate_c, v))
