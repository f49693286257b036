"""LFM2's gated short-convolution mixer: its plain reference.

HF ``Lfm2ShortConv`` (LFM2's token mixer in its ``conv`` layers), for a
sequence h [T, H] of the layer's normalised hidden state:

    B, C, x = split3(h @ W_in)     # W_in = in_proj.weight.T [H, 3H]
    u = B * x
    v[t] = w_0 u[t-2] + w_1 u[t-1] + w_2 u[t]   # depthwise causal Conv1d,
                                                # kernel 3, zero before 0
    y = (C * v) @ W_out            # W_out = out_proj.weight.T [H, H]

no biases, the padding tokens of h zeroed first (sequences padded on the
right).  One chip's share of a layer split by channel over 8 chips holds
channels [lo, hi): the rows of B, C and x for them (in_proj
column-parallel), their gates and conv, and out_proj's input channels
(row-parallel), so its y is the partial sum an all-reduce would complete.
The reference computes that share, in float64 (or the control's dtype),
from the weights and inputs the benchmark draws; matmuls run without TF32.
The output is column-packed as the head's is, so the head's judge and
packing serve it (``reference.head``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def weights(seed: int, hidden_size: int, conv_L_cache: int) -> dict:
    """PyTorch's default initialisations of ``nn.Linear(H, 3H)``,
    ``nn.Conv1d(H, H, L, groups=H)`` and ``nn.Linear(H, H)`` (no biases),
    in that order after ``torch.manual_seed(seed)``: U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) in float32 from a generator of their own; the nn
    layouts in_proj [3H, H], conv [H, L], out_proj [H, H]."""
    H, L = hidden_size, conv_L_cache
    g = torch.Generator().manual_seed(seed)

    def init(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return torch.empty(shape).uniform_(-bound, bound, generator=g)
    return {"in_proj": init((3 * H, H), H), "conv": init((H, L), L),
            "out_proj": init((H, H), H)}


def inputs(seed: int, input_count: int, num_row: int, hidden_size: int,
           lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
    """(lengths U{lo..hi}, h ~ N(0, 1) [input_count, num_row,
    hidden_size]), drawn from the seed's default stream in this order."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=input_count)
    return lens, rng.normal(0, 1, (input_count, num_row, hidden_size))


def share_output(h: np.ndarray, w: dict, lens: np.ndarray,
                 channels: tuple[int, int], dtype=torch.float64,
                 device="cpu") -> torch.Tensor:
    """The share's partial y [input_count, num_row, H] in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lo, hi = channels
    x = torch.as_tensor(h, device=device).to(dtype)
    H, T = x.shape[-1], x.shape[-2]
    valid = torch.arange(T, device=device)[None, :] < \
        torch.as_tensor(lens, device=device)[:, None]
    x = x * valid[..., None].to(dtype)
    rows = torch.cat([torch.arange(lo, hi) + k * H for k in range(3)])
    b, c, xs = (x @ w["in_proj"][rows].to(device, dtype).T).chunk(3, -1)
    u = b * xs
    taps = w["conv"][lo:hi].to(device, dtype)
    L = taps.shape[1]
    v = torch.zeros_like(u)
    for k in range(L):
        s = L - 1 - k
        v[:, s:] += taps[:, k] * u[:, :T - s]
    return (c * v) @ w["out_proj"][:, lo:hi].to(device, dtype).T

