"""Encrypted BERT-base encoder: attention, transformer layer, model.

Port of ``moai_tpu/models/bert.py``.  The bootstrap slot is a
``refresh(ct, n_q)`` callback, so the same layer runs with the harness
Recryptor or a real bootstrapper.

The JAX layer runs every stage over its whole column axis and vmaps the
heads.  At BERT-base width on one card that does not fit (the FFN's
[3072, 2, 20, N] product alone is 32 GB at N = 2^15), so the port runs a
memory plan whose every step gives the same residues as the unchunked
layer: Q/K/V per head (CPMM output columns are independent), LayerNorm by
column chunks (its sums are exact modular sums), the FFN by chunks of
d_inter (W_I columns -> GELU -> W_F rows, the W_F partial products summed
before the mask, the rescale and the bias).  The heads' softmax sums are
still refreshed as one [H, 2, n, N] batch, and the refreshes run in the
JAX layer's order, so with the Recryptor the layer is bit-identical to
the JAX one for one seed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from .. import mod_arith as ma
from ..ciphertext import Ciphertext
from ..encoder import Encoder
from ..evaluator import Evaluator
from ..ops.matmul import CPMM, ccmm_col_to_diag, ccmm_diag_to_col, \
    ccmm_col_steps, ccmm_diag_steps, col_chunk_for
from ..ops.nonlinear import (SoftmaxPts, softmax_exp_sum, softmax_finish,
                             layernorm, gelu, diag_valid_masks)
from ..ops.packing import bias_vec


@dataclasses.dataclass
class BertDims:
    """Workload constants."""
    num_x: int = 256          # interleaved batch size
    num_row: int = 128        # max tokens per input
    d_model: int = 768
    num_heads: int = 12
    head_dim: int = 64
    d_inter: int = 3072


@dataclasses.dataclass
class BertLayerWeights:
    """One encoder layer's parameters (float64 host arrays)."""
    wq: np.ndarray            # [d_model, num_heads*head_dim]
    bq: np.ndarray
    wk: np.ndarray
    bk: np.ndarray
    wv: np.ndarray
    bv: np.ndarray
    wo: np.ndarray            # [d_model, d_model]
    bo: np.ndarray
    ln1_g: np.ndarray
    ln1_b: np.ndarray
    wi: np.ndarray            # [d_model, d_inter]
    bi: np.ndarray
    wf: np.ndarray            # [d_inter, d_model]
    bf: np.ndarray
    ln2_g: np.ndarray
    ln2_b: np.ndarray


def load_reference_layer(layer_id: int, dims: BertDims,
                         root: str | None = None,
                         seed: int = 0) -> BertLayerWeights:
    """One layer's weights.  Biases and LayerNorm parameters come from the
    reference's golden CSVs under ``root`` (``layer_<id>/...``) where that
    directory holds them; the weight matrices, and everything when it does
    not, are synthesized deterministically at BERT-base magnitude, with the
    JAX package's draws in its order."""
    def csv(path):
        return np.loadtxt(path, delimiter=",", dtype=np.float64)

    rng = np.random.default_rng(seed * 1000 + layer_id)

    def synth(r, c, std):
        return rng.normal(0.0, std, size=(r, c))

    d, hh, di = dims.d_model, dims.num_heads * dims.head_dim, dims.d_inter
    base = f"{root}/layer_{layer_id}"
    sa = f"{base}/Attention/BertSelfAttention/parms"
    so = f"{base}/Attention/SelfOutput/parms"
    io = f"{base}/Intermediate/parms"
    oo = f"{base}/Output/parms"
    have = root is not None and os.path.isdir(sa)
    return BertLayerWeights(
        wq=synth(d, hh, 0.036), bq=csv(f"{sa}/query_bias.csv") if have else
        rng.normal(0, 0.02, hh),
        wk=synth(d, hh, 0.036), bk=csv(f"{sa}/key_bias.csv") if have else
        rng.normal(0, 0.02, hh),
        wv=synth(d, hh, 0.036), bv=csv(f"{sa}/value_bias.csv") if have else
        rng.normal(0, 0.02, hh),
        wo=synth(d, d, 0.03),
        bo=csv(f"{so}/self_output_dense_bias.csv") if have else
        rng.normal(0, 0.02, d),
        ln1_g=csv(f"{so}/self_output_LayerNorm_weight.csv") if have else
        np.ones(d),
        ln1_b=csv(f"{so}/self_output_LayerNorm_bias.csv") if have else
        np.zeros(d),
        wi=synth(d, di, 0.03),
        bi=csv(f"{io}/intermediate_dense_bias.csv") if have else
        rng.normal(0, 0.02, di),
        wf=synth(di, d, 0.02),
        bf=csv(f"{oo}/final_output_dense_bias.csv") if have else
        rng.normal(0, 0.02, d),
        ln2_g=csv(f"{oo}/final_output_LayerNorm_weight.csv") if have else
        np.ones(d),
        ln2_b=csv(f"{oo}/final_output_LayerNorm_bias.csv") if have else
        np.zeros(d),
    )


# --------------------------------------------------------------------------
# depth plan
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DepthPlan:
    """Composite-level budget per stage."""
    exp_r: int = 7            # exp squarings (8 levels with const mult)
    inv_iters: int = 16       # softmax inverse depth (iters+1 levels)
    ln_newton: int = 4
    ln_gold: int = 2
    gelu_degree: int = 24

    @property
    def softmax_pre(self) -> int:        # levels consumed before refresh
        return self.exp_r + 2            # const+squarings + mask

    @property
    def attention_in(self) -> int:       # levels needed entering a head
        # QK CPMM (1) + QKT CCMM (1) + softmax numerator path + AV (1)
        return 1 + 1 + self.softmax_pre + 1 + 1


class EncryptedAttention:
    """All heads of one layer's self-attention, head by head."""

    def __init__(self, ev: Evaluator, encoder: Encoder, w: BertLayerWeights,
                 dims: BertDims, plan: DepthPlan, n_att: int,
                 input_lens, max_table: float,
                 refresh: Callable[[Ciphertext, int], Ciphertext]):
        self.ev, self.encoder = ev, encoder
        self.dims, self.plan = dims, plan
        self.refresh = refresh
        self.max_val = max_table
        ctx = ev.ctx
        slots = ctx.cfg.slots
        mask = bias_vec(input_lens, dims.num_x, dims.num_row, slots)
        self.masks = diag_valid_masks(input_lens, dims.num_x, dims.num_row,
                                      slots)
        self.softmax_pts = SoftmaxPts(ev, encoder, self.masks)
        sqrt_d = np.sqrt(dims.head_dim)
        # 1/sqrt(d) folded into W_Q and b_Q
        self.q_mm = CPMM(ev, encoder, w.wq / sqrt_d, n_att,
                         bias=w.bq / sqrt_d, mask=mask)
        self.k_mm = CPMM(ev, encoder, w.wk, n_att, bias=w.bk, mask=mask)
        # V is consumed at the post-softmax level: computed there directly
        self.n_v = self._post_softmax_nq(n_att)
        self.v_mm = CPMM(ev, encoder, w.wv, self.n_v + 2, bias=w.bv,
                         mask=mask)
        self.n_att = n_att
        self.col_chunk = col_chunk_for(ctx, n_att - 2, dims.num_row)

    def _post_softmax_nq(self, n_att: int) -> int:
        # primes: QK costs 2, QKT 2, exp+mask 2*(exp_r+2), final mult 2
        return n_att - 2 * (1 + 1 + self.plan.softmax_pre + 1)

    def __call__(self, x: Ciphertext) -> Ciphertext:
        """x: col-packed [d_model, 2, n_att, N] -> [H*head_dim, 2, n, N]."""
        ev, dims, plan = self.ev, self.dims, self.plan
        H, hd = dims.num_heads, dims.head_dim
        heads = [slice(h * hd, (h + 1) * hd) for h in range(H)]
        es, ss, pts = [], [], None
        for cols in heads:
            qkt = ccmm_col_to_diag(ev, self.q_mm(x, cols=cols),
                                   self.k_mm(x, cols=cols), dims.num_x,
                                   dims.num_row, col_chunk=self.col_chunk)
            if pts is None:                  # the same for every head
                pts = self.softmax_pts(self.max_val, qkt.scale, qkt.n_q,
                                       exp_r=plan.exp_r)
            e, s = softmax_exp_sum(ev, self.encoder, qkt, self.masks,
                                   self.max_val, exp_r=plan.exp_r, pts=pts)
            del qkt
            es.append(e)
            ss.append(s.data)
        del pts
        # the inverse consumes inv_iters+1 levels; land it at e's level
        n_refresh = min(ev.ctx.L, self.n_v + 2 + 2 * (plan.inv_iters + 1))
        s = self.refresh(s.with_data(torch.stack(ss)), n_refresh)  # ONE
        del ss
        xv = ev.mod_drop_to(x, self.n_v + 2)
        outs = []
        for h, cols in enumerate(heads):
            sm = softmax_finish(ev, es[h], s.with_data(s.data[h]),
                                inv_iters=plan.inv_iters, out_n_q=self.n_v)
            es[h] = None
            out = ccmm_diag_to_col(ev, sm, self.v_mm(xv, cols=cols),
                                   dims.num_x, dims.num_row)
            outs.append(out.data)
        return Ciphertext(torch.cat(outs), out.scale, True)


# The layer's LayerNorm and FFN column chunk: a chunk's input at the full
# level, [chunk, 2, L, N] int32, within LAYER_CHUNK_BYTES (at logN 15 and
# 28 primes: 128 columns).  The FFN's GELU holds several times its input at
# once (its Chebyshev powers and a key switch's transients); at 128
# columns the BERT-base layer peaks at ~52 GiB on an 80 GB card.
LAYER_CHUNK_BYTES = 7 << 27


class EncryptedBertLayer:
    """One full transformer encoder layer: attention -> W_O + bias ->
    refresh -> residual -> LayerNorm -> refresh -> FFN -> GELU -> W_F ->
    refresh -> residual -> LayerNorm -> refresh.

    LayerNorm's column axis and the FFN's d_inter axis are processed in
    chunks of ``col_chunk`` ciphertexts, from LAYER_CHUNK_BYTES and the
    context; the result does not depend on it."""

    def __init__(self, ev: Evaluator, encoder: Encoder, w: BertLayerWeights,
                 dims: BertDims, plan: DepthPlan, input_lens,
                 max_table: float,
                 refresh: Callable[[Ciphertext, int], Ciphertext],
                 ln1_domain=(0.05, 1.0), ln2_domain=(0.05, 1.0),
                 gelu_domain: float = 13.0):
        ctx = ev.ctx
        self.ev, self.encoder = ev, encoder
        self.dims, self.plan = dims, plan
        self.refresh = refresh
        slots = ctx.cfg.slots
        mask = bias_vec(input_lens, dims.num_x, dims.num_row, slots)
        # attention entry: head pipeline depth + two spare levels at the
        # bottom (a margin level, and one a bootstrapping refresh can spend
        # re-landing the W_O output's drifted composite scale)
        self.n_att = min(ctx.L, ctx.n_q0 + 2 * plan.attention_in + 4)
        self.attn = EncryptedAttention(ev, encoder, w, dims, plan,
                                       self.n_att, input_lens, max_table,
                                       refresh)
        n_out = self.attn._post_softmax_nq(self.n_att) - 2
        self.o_mm = CPMM(ev, encoder, w.wo, n_out, bias=w.bo, mask=mask)
        # LayerNorm consumes 6 + 3*newton + 2*gold composite levels
        ln_depth = 6 + 3 * plan.ln_newton + 2 * plan.ln_gold
        self.n_ln1 = min(ctx.L, ctx.n_q0 + 2 * ln_depth + 2)
        # GELU: prescale + Chebyshev doubling ladder + coefficient mult
        deg = plan.gelu_degree
        gelu_depth = 2 + max(1, (deg - 1).bit_length())
        self.n_ffn = min(ctx.L, ctx.n_q0 + 2 * (1 + gelu_depth + 1) + 2)
        self.i_mm = CPMM(ev, encoder, w.wi, self.n_ffn, bias=w.bi, mask=mask)
        self.f_mm = CPMM(ev, encoder, w.wf,
                         self.n_ffn - 2 * (1 + gelu_depth),
                         bias=w.bf, mask=mask)
        self.w = w
        self.ln1_domain, self.ln2_domain = ln1_domain, ln2_domain
        self.gelu_domain = gelu_domain
        self.col_chunk = max(1, LAYER_CHUNK_BYTES // (2 * ctx.L * ctx.cfg.N
                                                      * 4))

    def _residual(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        q = self.ev.dev["q"][:a.n_q].reshape(-1, 1)
        return a.with_data(ma.add_mod(a.data, b.data, q))

    def _ffn(self, h: Ciphertext) -> Ciphertext:
        """W_I -> GELU -> W_F (+ biases) over d_inter in column chunks."""
        ev, di, cc = self.ev, self.dims.d_inter, self.col_chunk
        acc = None
        for lo in range(0, di, cc):
            cols = slice(lo, min(lo + cc, di))
            g = gelu(ev, self.i_mm(h, cols=cols), domain=self.gelu_domain,
                     degree=self.plan.gelu_degree)
            part = self.f_mm.product(g, rows=cols)
            acc = part if acc is None else \
                ma.add_mod(acc, part, ev.dev["q"][:g.n_q].reshape(-1, 1))
        return self.f_mm.finish(acc, g.scale)

    def __call__(self, x: Ciphertext) -> Ciphertext:
        """x: col-packed [d_model, 2, n_att, N] at the attention level."""
        ev, plan = self.ev, self.plan
        att = self.o_mm(self.attn(x))                        # [d, 2, *, N]
        att = self.refresh(att, self.n_ln1)
        h = self._residual(att, self.refresh(x, self.n_ln1))
        del att
        h = layernorm(ev, h, self.w.ln1_g, self.w.ln1_b, self.ln1_domain,
                      plan.ln_newton, plan.ln_gold, col_chunk=self.col_chunk)
        h = self.refresh(h, self.n_ffn)
        f = self.refresh(self._ffn(h), self.n_ln1)
        h2 = self._residual(f, self.refresh(h, self.n_ln1))
        del f, h
        h2 = layernorm(ev, h2, self.w.ln2_g, self.w.ln2_b, self.ln2_domain,
                       plan.ln_newton, plan.ln_gold, col_chunk=self.col_chunk)
        return self.refresh(h2, self.n_att)


def galois_steps_for_model(dims: BertDims) -> list[int]:
    """Rotation-key step plan for the whole model."""
    steps = set(ccmm_col_steps(dims.num_x, dims.num_row))
    steps.update(ccmm_diag_steps(dims.num_x, dims.num_row))
    return sorted(steps)


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

# Per-layer empirical max of the attention scores QK^T, subtracted before
# exp so the numerators stay in (0, 1] (reference data constant:
# minus_index_vec, softmax.hpp:324).
BERT_BASE_MAX_TABLE = [7.5, 9.9, 13.6, 13.3, 9.5, 8.0, 10.3, 9.0, 9.0, 9.0,
                       11.0, 7.0]


def read_reference_input(dims: BertDims, path: str) -> np.ndarray:
    """The reference's embedded input matrix (``layer_0/
    embedded_inputs.csv`` of its golden data: one input of 5 valid tokens,
    tokens beyond that zero-padded).  Returns [1, num_row, d_model]."""
    m = np.loadtxt(path, delimiter=",", dtype=np.float64)
    out = np.zeros((1, dims.num_row, dims.d_model))
    r = min(m.shape[0], dims.num_row)
    out[0, :r, :m.shape[1]] = m[:r, :dims.d_model]
    return out


class EncryptedBertModel:
    """The stacked encrypted BERT-base encoder.  Each layer re-enters at
    ``n_att`` via the trailing refresh, so the stack composes without
    per-layer re-keying.

    ``domains``: optional list of per-layer dicts with keys
    ``ln1/ln2/gelu`` overriding the nonlinear approximation domains
    (calibrated from a plaintext forward pass, ``calibrate_domains``)."""

    def __init__(self, ev: Evaluator, encoder: Encoder,
                 weights: list[BertLayerWeights], dims: BertDims,
                 plan: DepthPlan, input_lens,
                 refresh: Callable[[Ciphertext, int], Ciphertext],
                 max_table=None, domains: list[dict] | None = None,
                 on_layer: Callable[[int, Ciphertext], None] | None = None):
        max_table = max_table if max_table is not None else \
            BERT_BASE_MAX_TABLE
        self.layers = []
        for i, w in enumerate(weights):
            dom = (domains[i] if domains is not None else {})
            self.layers.append(EncryptedBertLayer(
                ev, encoder, w, dims, plan, input_lens,
                max_table=float(max_table[i % len(max_table)]),
                refresh=refresh,
                ln1_domain=dom.get("ln1", (0.05, 1.0)),
                ln2_domain=dom.get("ln2", (0.05, 1.0)),
                gelu_domain=dom.get("gelu", 13.0)))
        self.on_layer = on_layer

    @property
    def n_att(self) -> int:
        return self.layers[0].n_att

    def __call__(self, x: Ciphertext, start_layer: int = 0) -> Ciphertext:
        """Run layers[start_layer:]; ``start_layer > 0`` resumes from a
        saved inter-layer ciphertext passed as ``x``."""
        if not 0 <= start_layer <= len(self.layers):
            raise ValueError(f"start_layer {start_layer} outside "
                             f"[0, {len(self.layers)}]")
        for i in range(start_layer, len(self.layers)):
            x = self.layers[i](x)
            if self.on_layer is not None:
                self.on_layer(i, x)
        return x


def plain_bert_layer(x: np.ndarray, w: BertLayerWeights, dims: BertDims
                     ) -> np.ndarray:
    """Exact float reference for one input [T, d_model]."""
    from scipy.special import erf

    hd, H = dims.head_dim, dims.num_heads

    def ln(v, g_, b_):
        mu = v.mean(-1, keepdims=True)
        sg = v.std(-1, keepdims=True)
        return g_ * (v - mu) / sg + b_

    q = x @ w.wq / np.sqrt(hd) + w.bq / np.sqrt(hd)
    k = x @ w.wk + w.bk
    v = x @ w.wv + w.bv
    outs = []
    for h in range(H):
        sl = slice(h * hd, (h + 1) * hd)
        sc = q[:, sl] @ k[:, sl].T
        e = np.exp(sc - sc.max())
        outs.append(e / e.sum(-1, keepdims=True) @ v[:, sl])
    att = np.concatenate(outs, axis=-1) @ w.wo + w.bo
    h1 = ln(att + x, w.ln1_g, w.ln1_b)
    f = h1 @ w.wi + w.bi
    f = 0.5 * f * (1 + erf(f / np.sqrt(2)))
    return ln(f @ w.wf + w.bf + h1, w.ln2_g, w.ln2_b)


def calibrate_domains(xs: np.ndarray, lens, weights: list[BertLayerWeights],
                      dims: BertDims, margin: float = 1.4
                      ) -> tuple[list[dict], list[float]]:
    """Plaintext calibration pass: per-layer LayerNorm variance-sum
    domains, GELU input range, and softmax max table, derived from a
    plaintext forward pass over the actual batch."""
    from scipy.special import erf

    d = dims.d_model
    domains, max_table = [], []
    cur = [xs[j, :lens[j]].copy() for j in range(xs.shape[0])]
    for w in weights:
        qmax, s1_lo, s1_hi, s2_lo, s2_hi, gmax = 0.0, np.inf, 0.0, np.inf, \
            0.0, 0.0
        nxt = []
        for x in cur:
            q = x @ w.wq / np.sqrt(dims.head_dim) + w.bq / np.sqrt(
                dims.head_dim)
            k = x @ w.wk + w.bk
            for h in range(dims.num_heads):
                sl = slice(h * dims.head_dim, (h + 1) * dims.head_dim)
                qmax = max(qmax, float(np.abs(q[:, sl] @ k[:, sl].T).max()))
            y = plain_bert_layer(x, w, dims)

            def S(v):
                dd = d * v - v.sum(-1, keepdims=True)
                return (dd * dd).sum(-1)

            # recompute intermediates for domains
            hd, H = dims.head_dim, dims.num_heads
            vv = x @ w.wv + w.bv
            outs = []
            for h in range(H):
                sl = slice(h * hd, (h + 1) * hd)
                sc = q[:, sl] @ k[:, sl].T
                e = np.exp(sc - sc.max())
                outs.append(e / e.sum(-1, keepdims=True) @ vv[:, sl])
            att = np.concatenate(outs, -1) @ w.wo + w.bo
            pre1 = att + x
            s1 = S(pre1)
            s1_lo, s1_hi = min(s1_lo, s1.min()), max(s1_hi, s1.max())
            mu = pre1.mean(-1, keepdims=True)
            sg = pre1.std(-1, keepdims=True)
            h1 = w.ln1_g * (pre1 - mu) / sg + w.ln1_b
            f = h1 @ w.wi + w.bi
            gmax = max(gmax, float(np.abs(f).max()))
            f = 0.5 * f * (1 + erf(f / np.sqrt(2)))
            pre2 = f @ w.wf + w.bf + h1
            s2 = S(pre2)
            s2_lo, s2_hi = min(s2_lo, s2.min()), max(s2_hi, s2.max())
            nxt.append(y)
        domains.append({"ln1": (s1_lo / margin, s1_hi * margin),
                        "ln2": (s2_lo / margin, s2_hi * margin),
                        "gelu": gmax * margin})
        max_table.append(qmax)
        cur = nxt
    return domains, max_table
