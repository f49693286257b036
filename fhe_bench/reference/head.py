"""The encrypted attention head's plain reference and its judge.

The head the program runs (MOAI's interleaved column packing, IACR ePrint
2025/991): for each input j of ``lens[j]`` valid tokens x [n, d_model],

    q, k, v = x W_Q + b_Q, x W_K + b_K, x W_V + b_V   (1/sqrt(d_h) in W_Q, b_Q)
    e = (1 + (q k^T - MAX_VAL) / 2^r)^(2^r)           (r squarings)
    s = sum_cols(e) / num_row + EPS / num_row
    inv = prod_{i <= iters} (1 + (1 - s)^(2^i))       (Goldschmidt)
    out = (e / num_row * inv) v

and zero for the rows past ``lens[j]``.  The circuit states these
approximations of exp and of the inverse, so the reference computes the
same function, in float64, from the weights and inputs the benchmark
draws.  ``head_output`` takes a ``dtype``: in the configuration's
``control_dtype`` it is the control that has to fail a limit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ckks

FAIL = 1e30        # a number compared on an output of the wrong shape

MAX_VAL = 2.0
EPS = 1e-5


def weights(seed: int, d_model: int, head_dim: int) -> dict:
    """W_Q, b_Q, W_K, b_K, W_V, b_V at BERT-base magnitude (weights std
    0.036, biases 0.02), 1/sqrt(head_dim) folded into W_Q and b_Q; drawn
    from a stream of the seed that the program does not draw from."""
    rng = np.random.default_rng([seed, 1])
    s = np.sqrt(head_dim)
    return dict(wq=rng.normal(0, 0.036, (d_model, head_dim)) / s,
                bq=rng.normal(0, 0.02, head_dim) / s,
                wk=rng.normal(0, 0.036, (d_model, head_dim)),
                bk=rng.normal(0, 0.02, head_dim),
                wv=rng.normal(0, 0.036, (d_model, head_dim)),
                bv=rng.normal(0, 0.02, head_dim))


def inputs(seed: int, input_count: int, num_row: int, d_model: int,
           lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
    """(lengths U{lo..hi}, tokens N(0, 0.5) [input_count, num_row,
    d_model]), drawn from the seed's default stream in this order."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=input_count)
    xs = rng.normal(0, 0.5, (input_count, num_row, d_model))
    return lens, xs


def _pow2(x: torch.Tensor, times: int) -> torch.Tensor:
    for _ in range(times):
        x = x * x
    return x


def head_output(xs: np.ndarray, w: dict, lens: np.ndarray, exp_r: int,
                inv_iters: int, num_row: int, dtype=torch.float64,
                device="cpu") -> torch.Tensor:
    """[input_count, num_row, head_dim] in ``dtype``."""
    t = {k: torch.as_tensor(v, dtype=dtype, device=device)
         for k, v in w.items()}
    x = torch.as_tensor(xs, dtype=dtype, device=device)
    valid = torch.arange(xs.shape[1], device=device)[None, :] < \
        torch.as_tensor(lens, device=device)[:, None]          # [I, R]
    q = x @ t["wq"] + t["bq"]
    k = x @ t["wk"] + t["bk"]
    v = x @ t["wv"] + t["bv"]
    e = _pow2(1.0 + (q @ k.transpose(1, 2) - MAX_VAL) / (1 << exp_r), exp_r)
    e = e * valid[:, None, :].to(dtype)
    s = e.sum(-1) / num_row + EPS / num_row
    y = 1.0 - s
    inv = torch.ones_like(s)
    for i in range(inv_iters + 1):
        inv = inv * (1.0 + _pow2(y, i))
    out = (e / num_row * inv[..., None]) @ v
    return out * valid[..., None].to(dtype)


def unpack(slots: torch.Tensor, num_x: int, num_row: int,
           input_count: int) -> torch.Tensor:
    """Column-packed slots [head_dim, num_x * num_row] -> [input_count,
    num_row, head_dim]: slot num_x * k + j holds token k of input j."""
    idx = num_x * torch.arange(num_row, device=slots.device)[None, :] + \
        torch.arange(input_count, device=slots.device)[:, None]
    return slots[:, idx].permute(1, 2, 0)


def pack(want: torch.Tensor, spec: dict) -> torch.Tensor:
    """[input_count, num_row, head_dim] -> the column-packed slots
    [head_dim, N/2] that ``unpack`` reads (slots of no input hold 0)."""
    slots = torch.zeros((spec["head_dim"], spec["N"] // 2),
                        dtype=torch.complex128, device=want.device)
    idx = spec["num_x"] * torch.arange(spec["num_row"],
                                       device=want.device)[None, :] + \
        torch.arange(want.shape[0], device=want.device)[:, None]
    slots[:, idx] = want.permute(2, 0, 1).to(torch.complex128)
    return slots


def judge(data: torch.Tensor, scale: float, spec: dict, want: torch.Tensor
          ) -> dict:
    """The numbers compared for one head output (ciphertext residues
    ``data`` at ``scale``) against ``want`` [input_count, num_row,
    head_dim]: max_abs_err and rms_err (the largest and the
    root-mean-square complex modulus of decoded - want, over every token
    and column), limbs_off, limb_mismatch."""
    out = {"limbs_off": abs(data.shape[-2] - spec["out_limbs"])}
    shape = (spec["head_dim"], 2, spec["out_limbs"], spec["N"])
    if tuple(data.shape) != shape:
        out.update(max_abs_err=FAIL, rms_err=FAIL, limb_mismatch=FAIL)
        return out
    s = ckks.secret_key(spec["seed"], spec["N"], spec["hamming_weight"])
    c = ckks.decrypt_coeffs(data, spec["q_primes"], s)
    m, bad = ckks.crt_message(c, spec["q_primes"])
    got = unpack(ckks.decode(m, scale), spec["num_x"], spec["num_row"],
                 want.shape[0])
    err = (got - want.to(got.device)).abs()
    out.update(max_abs_err=float(err.max()),
               rms_err=float(err.square().mean().sqrt()), limb_mismatch=bad)
    return out
