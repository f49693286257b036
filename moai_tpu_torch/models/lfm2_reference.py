"""LFM2's gated short-convolution mixer (HF ``Lfm2ShortConv``), plain.

The plain reference of ``models.lfm2.EncryptedShortConv``, in plain torch
and float64; it imports nothing of the port.  For a sequence h [T, H]
(the layer's normalised hidden state):

    B, C, x = split3(h @ W_in)     # W_in = in_proj.weight.T [H, 3H]
    u = B * x
    v[t] = w_0 u[t-L+1] + ... + w_{L-1} u[t]   # depthwise causal Conv1d,
                                              # kernel L, zero before t = 0
    y = (C * v) @ W_out            # W_out = out_proj.weight.T [H, H]

with no biases (``conv_bias`` false), the padding tokens of h zeroed first
(HF's ``apply_mask_to_padding_states``, sequences padded on the right).

A channel share [lo, hi) of a layer split by channel, as tensor
parallelism splits it: in_proj column-parallel (the rows lo..hi of B, C
and x), the conv and the gates per channel, out_proj row-parallel (its
input channels lo..hi).  The share's y is that chip's partial sum, which
an all-reduce over the shares would add up to the layer's y.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def weights(seed: int, hidden_size: int, conv_L_cache: int) -> dict:
    """The mixer's weights as PyTorch initialises ``nn.Linear(H, 3H,
    bias=False)``, ``nn.Conv1d(H, H, L, groups=H, bias=False)`` and
    ``nn.Linear(H, H, bias=False)`` in that order after
    ``torch.manual_seed(seed)`` (kaiming-uniform with a = sqrt(5), so
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in H, L and H), drawn from a
    generator of their own: float32 ``in_proj`` [3H, H], ``conv`` [H, L],
    ``out_proj`` [H, H], the nn layouts."""
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
    hidden_size]), drawn from the seed's default numpy stream in this
    order: an RMSNorm's output with its weight at ones."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=input_count)
    return lens, rng.normal(0, 1, (input_count, num_row, hidden_size))


def held_rows(hidden_size: int, channels: tuple[int, int]) -> torch.Tensor:
    """The rows of in_proj.weight that a share holds: those of B, C and
    x for its channels, in that order."""
    lo, hi = channels
    return torch.cat([torch.arange(lo, hi) + k * hidden_size
                      for k in range(3)])


def causal_conv(u: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv over the token axis: u [..., T, c], taps
    [c, L] -> v[t] = sum_k taps[:, k] u[t - (L-1-k)], zero before 0."""
    L = taps.shape[-1]
    v = torch.zeros_like(u)
    for k in range(L):
        s = L - 1 - k
        v[..., s:, :] += taps[:, k] * u[..., :u.shape[-2] - s, :]
    return v


def mixer(h, w: dict, lens=None, channels: tuple[int, int] | None = None,
          dtype=torch.float64, device="cpu") -> torch.Tensor:
    """y [..., T, H] in ``dtype`` of h [..., T, H] (numpy or torch):
    the whole mixer, or with ``channels`` (lo, hi) that share's partial
    y.  ``lens`` [...] zeroes each sequence's tokens past its length in h,
    so their y is zero too.  Matmuls in float32 run without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = torch.as_tensor(h, device=device).to(dtype)
    H = h.shape[-1]
    channels = channels or (0, H)
    lo, hi = channels
    if lens is not None:
        t = torch.arange(h.shape[-2], device=device)
        valid = t < torch.as_tensor(np.asarray(lens), device=device)[
            ..., None]
        h = h * valid[..., None].to(dtype)
    w_in = w["in_proj"][held_rows(H, channels)].to(device=device,
                                                   dtype=dtype)
    B, C, x = (h @ w_in.T).chunk(3, dim=-1)
    v = causal_conv(B * x, w["conv"][lo:hi].to(device=device, dtype=dtype))
    return (C * v) @ w["out_proj"][:, lo:hi].to(device=device,
                                                dtype=dtype).T
