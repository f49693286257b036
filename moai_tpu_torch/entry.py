"""The encrypted attention head, end to end.

Port of ``__graft_entry__._build_head``: one full encrypted attention head
(Q/K/V CPMM -> QK^T CCMM -> polynomial softmax with an in-budget
Goldschmidt inverse -> softmax*V CCMM) over an interleaved batch of
``num_x`` inputs of ``num_row`` tokens.  ``head_oracle`` computes the same
function, with the same polynomial approximations, in float64 numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from .ciphertext import Ciphertext
from .encoder import Encoder
from .encrypt import Encryptor, Decryptor
from .evaluator import Evaluator
from .keys import KeyGenerator
from .ops.matmul import (CPMM, ccmm_col_to_diag, ccmm_diag_to_col,
                         ccmm_col_steps, ccmm_diag_steps, _bsgs_split)
from .ops.nonlinear import softmax_diag, diag_valid_masks
from .ops.packing import batch_input, bias_vec, unpack_batch
from .params import Context, head_config, resolve_device

MAX_VAL = 2.0           # softmax shift: scores enter exp as x - MAX_VAL
EPS = 1e-5              # added to the exp-sum before the inverse
# bound on the rotated operands ccmm_col_to_diag holds per column chunk
ROT_OPERAND_BYTES = 4 << 30


@dataclasses.dataclass
class Head:
    fn: Callable[[torch.Tensor], Ciphertext]   # x data -> head output
    x_data: torch.Tensor       # encrypted input [d_model, 2, L, N]
    ctx: Context
    decryptor: Decryptor
    xs: np.ndarray             # plaintext input [input_count, num_row, d]
    weights: dict              # wq, bq, wk, bk, wv, bv
    lens: np.ndarray           # valid tokens per input
    num_x: int
    num_row: int
    exp_r: int
    inv_iters: int

    def decode(self, out: Ciphertext) -> np.ndarray:
        """Decrypt the head output -> [input_count, num_row, head_dim]."""
        sm = self.decryptor.decrypt(out).real
        return unpack_batch(sm, self.num_x, self.num_row, len(self.lens))

    def oracle(self) -> np.ndarray:
        return head_oracle(self.xs, self.weights, self.lens, self.exp_r,
                           self.inv_iters, self.num_row)


def col_chunk_for(ctx: Context, n_q: int, num_row: int) -> int:
    """Columns per ccmm_col_to_diag chunk: the g+b rotated copies of a
    chunk, [g+b, chunk, 2, n_q, N] int64, stay within ROT_OPERAND_BYTES."""
    g, b = _bsgs_split(num_row)
    per_col = (g + b) * 2 * n_q * ctx.cfg.N * 8
    return max(1, ROT_OPERAND_BYTES // per_col)


def balanced_input_scale(ctx: Context, exp_r: int, inv_iters: int) -> float:
    """The input encoding scale that keeps the head's squaring chain on the
    context's nominal scale.

    A rescale divides by the top prime pair of its level, and 26-bit pairs
    differ from one another by up to ~1%.  The head squares its scale once
    in QK^T, exp_r times in exp and inv_iters times in the inverse, with a
    scale-preserving step between (the exp's constant, the mask), so a
    start off by e bits ends off by 2^(1+exp_r+inv_iters) e bits: at logN
    15 the nominal scale drifts to 2^107 at the output, past q0.  Walking
    the chain backwards from ctx.scale (before a squaring that divides by
    pair p, log s = (log s_next + log p) / 2) gives the start that lands
    the last squaring on ctx.scale; the intermediate scales then stay
    within a few hundredths of a bit of it."""
    L = ctx.L
    levels = ([L - 2] + [L - 6 - 2 * i for i in range(exp_r)]
              + [L - 8 - 2 * exp_r - 2 * i for i in range(inv_iters)])
    lg = math.log2(ctx.scale)
    for n in reversed(levels):
        lg = (lg + math.log2(ctx.q_primes[n - 1])
              + math.log2(ctx.q_primes[n - 2])) / 2
    return 2.0 ** lg


def build_head(logN: int, n_data_levels: int, num_x: int, num_row: int,
               d_model: int, head_dim: int, exp_r: int, inv_iters: int,
               input_count: int, seed: int = 11, device="cuda",
               weights: dict | None = None,
               nominal_input_scale: bool = False) -> Head:
    """Keys, weights, plaintexts and the encrypted input of one head.

    ``weights`` holds wq [d_model, head_dim] (1/sqrt(head_dim) folded in),
    bq, wk, bk, wv, bv; with ``weights=None`` they are drawn as
    ``_build_head`` draws them.  The input is encoded at
    ``balanced_input_scale``, or with ``nominal_input_scale`` at ctx.scale
    as ``_build_head`` encodes it: with both, every draw and every residue
    is the one ``_build_head`` makes, so the output matches it bit for
    bit."""
    dev = resolve_device(device)
    cfg = head_config(logN, n_data_levels)
    ctx = Context(cfg, device=dev)
    slots = cfg.slots
    if num_x * num_row != slots:
        raise ValueError(f"num_x*num_row = {num_x * num_row} != {slots} slots")
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=seed, device=dev)
    steps = sorted(set(ccmm_col_steps(num_x, num_row)
                       + ccmm_diag_steps(num_x, num_row)))
    gks = kg.gen_galois_keys(steps=steps)
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device=dev)
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), galois_keys=gks,
                   device=dev)

    rng = np.random.default_rng(seed)
    lens = rng.integers(num_row // 2, num_row + 1, size=input_count)
    mask = bias_vec(lens, num_x, num_row, slots)
    masks = diag_valid_masks(lens, num_x, num_row, slots)

    n_att = ctx.L
    # level plan (composite levels, no bootstrap): QK CPMM 1, QKT 1,
    # exp 1+exp_r, mask 1, inverse inv_iters+1, final mult 1, AV 1
    n_v = n_att - 2 * (2 + exp_r + 2 + inv_iters + 1 + 1)
    if n_v - 2 < ctx.n_q0:
        raise ValueError(f"chain too short: V level {n_v}")

    if weights is None:
        wq = rng.normal(0, 0.2, (d_model, head_dim)) / np.sqrt(head_dim)
        wk = rng.normal(0, 0.2, (d_model, head_dim))
        wv = rng.normal(0, 0.2, (d_model, head_dim))
        bq = rng.normal(0, 0.1, head_dim)
        bk = rng.normal(0, 0.1, head_dim)
        bv = rng.normal(0, 0.1, head_dim)
        weights = dict(wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv)
    w = weights
    q_mm = CPMM(ev, enc, w["wq"], n_att, bias=w["bq"], mask=mask)
    k_mm = CPMM(ev, enc, w["wk"], n_att, bias=w["bk"], mask=mask)
    v_mm = CPMM(ev, enc, w["wv"], n_v + 2, bias=w["bv"], mask=mask)
    col_chunk = col_chunk_for(ctx, n_att - 2, num_row)

    x_scale = ctx.scale if nominal_input_scale else \
        balanced_input_scale(ctx, exp_r, inv_iters)

    def head_fn(x_data: torch.Tensor) -> Ciphertext:
        x = Ciphertext(x_data, x_scale, True)
        q = q_mm(x)
        k = k_mm(x)
        v = v_mm(ev.mod_drop_to(x, n_v + 2))
        qkt = ccmm_col_to_diag(ev, q, k, num_x, num_row, col_chunk=col_chunk)
        del q, k
        sm = softmax_diag(ev, enc, qkt, masks, max_val=MAX_VAL,
                          refresh=lambda ct: ct, inv_iters=inv_iters,
                          eps=EPS, out_n_q=n_v, exp_r=exp_r)
        del qkt
        return ccmm_diag_to_col(ev, sm, v, num_x, num_row)

    xs = rng.normal(0, 0.5, (input_count, num_row, d_model))
    x0 = batch_input(encryptor, xs, num_x, num_row, scale=x_scale, n_q=n_att)
    return Head(head_fn, x0.data, ctx,
                Decryptor(ctx, enc, kg.sk, device=dev), xs, dict(weights),
                np.asarray(lens), num_x, num_row, exp_r, inv_iters)


def head_oracle(xs: np.ndarray, weights: dict, lens, exp_r: int,
                inv_iters: int, num_row: int, max_val: float = MAX_VAL,
                eps: float = EPS) -> np.ndarray:
    """The head in float64 with the circuit's approximations: masked Q/K/V,
    exp(x) ~ (1 + x/2^r)^(2^r) on x = QK^T - max_val, the exp-sum over
    num_row diagonals scaled by 1/num_row plus eps/num_row, and the
    Goldschmidt product prod_{i<=iters} (1 + y^(2^i)), y = 1 - sum.
    Returns [input_count, num_row, head_dim]; rows past a length are 0."""
    w = weights
    out = np.zeros(xs.shape[:2] + (w["wv"].shape[1],))
    for j, n in enumerate(np.asarray(lens)):
        x = xs[j, :n]
        q = x @ w["wq"] + w["bq"]
        k = x @ w["wk"] + w["bk"]
        v = x @ w["wv"] + w["bv"]
        e = (1.0 + (q @ k.T - max_val) / (1 << exp_r)) ** (1 << exp_r)
        s = e.sum(1) / num_row + eps / num_row
        y = 1.0 - s
        inv = np.ones_like(s)
        for i in range(inv_iters + 1):
            inv *= 1.0 + y ** (1 << i)
        out[j, :n] = (e / num_row * inv[:, None]) @ v
    return out
