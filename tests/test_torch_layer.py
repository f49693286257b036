"""The encrypted BERT encoder layer of moai_tpu_torch (entry.build_layer, on
the harness Recryptor) at logN 9 (L 22) with tiny widths: 32 inputs of 8
tokens, d_model 8, 2 heads of 4, d_inter 16, DepthPlan(2, 2, 1, 0, 8),
3 inputs, seed 11, weights from load_reference_layer.

Tier 1 holds the decrypted output to ``layer_oracle``, which repeats the
circuit's approximations (exp, Goldschmidt inverse, the S-domain LayerNorm
with its linear rsqrt init and Newton steps, the Chebyshev GELU), so what
remains is CKKS noise and the 2^-26 quantization of weights and masks: the
port is 3.75e-9 from it here on outputs up to 2.29, so the tolerance is
1e-8.  The chunked memory plan (LayerNorm and FFN column chunks, CPMM
column slices and row partial sums) gives the residues of the unchunked
layer.  The slow test holds the whole layer bit-identical to
``moai_tpu.models.bert.EncryptedBertLayer`` on the same seeds."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from moai_tpu_torch import convert
from moai_tpu_torch.ciphertext import Ciphertext
from moai_tpu_torch.entry import build_layer, layer_oracle
from moai_tpu_torch.models import bert
from moai_tpu_torch.models.bert import (BertDims, DepthPlan,
                                        EncryptedBertModel,
                                        calibrate_domains,
                                        load_reference_layer)
from moai_tpu_torch.ops.matmul import CPMM
from moai_tpu_torch.ops.packing import bias_vec
from moai_tpu_torch.params import Context, head_config

torch.set_num_threads(1)
DIMS = BertDims(num_x=32, num_row=8, d_model=8, num_heads=2, head_dim=4,
                d_inter=16)
PLAN = DepthPlan(exp_r=2, inv_iters=2, ln_newton=1, ln_gold=0,
                 gelu_degree=8)
LOGN, LEVELS, INPUTS = 9, 10, 3
TOL = 1e-8
# the approximations' cost at this plan (exp_r 2, inverse of 3 terms, one
# Newton step, degree-8 GELU): the oracle is 0.105 from the exact layer
PLAIN_TOL = 0.15


@pytest.fixture(scope="module")
def layer():
    return build_layer(LOGN, LEVELS, DIMS, PLAN, INPUTS, device="cpu")


@pytest.fixture(scope="module")
def out(layer):
    return layer.fn(layer.x_data)


def test_layer_matches_oracle(layer, out):
    assert (layer.ctx.L, layer.layer.n_att, layer.layer.n_ln1,
            layer.layer.n_ffn) == (22, 22, 22, 18)
    assert out.n_q == layer.layer.n_att
    assert out.data.shape[0] == DIMS.d_model
    got = layer.decode(out)
    assert got.shape == (INPUTS, DIMS.num_row, DIMS.d_model)
    assert np.isfinite(got).all()
    assert np.abs(got - layer.oracle()).max() < TOL
    rows = np.arange(DIMS.num_row)[None, :] < layer.lens[:, None]
    assert np.abs(got - layer.plain())[rows].max() < PLAIN_TOL
    # one refresh of the heads' sums, then att, x, h, f, boot copy, h2
    assert [(s, n) for s, n, *_ in layer.refresh_log] == [
        ((2,), 16), ((8,), 22), ((8,), 22), ((8,), 18), ((8,), 22),
        ((8,), 22), ((8,), 22)]


def test_oracle_is_the_layer_in_the_limit(layer):
    """With many squarings, iterations and a high-degree GELU the oracle
    converges to plain_bert_layer (checks the oracle itself)."""
    plan = DepthPlan(exp_r=24, inv_iters=40, ln_newton=8, ln_gold=2,
                     gelu_degree=40)
    got = layer_oracle(layer.xs, layer.weights, layer.lens, DIMS, plan,
                       layer.max_val, layer.domains, eps=0.0)
    rows = np.arange(DIMS.num_row)[None, :] < layer.lens[:, None]
    assert np.abs(got - layer.plain())[rows].max() < 1e-5


@pytest.mark.parametrize("col_chunk", [3, 5])
def test_chunked_layer_identical(layer, out, monkeypatch, col_chunk):
    """LayerNorm and the FFN in column chunks (uneven ones included), from
    a lowered byte bound: the same residues as whole, refreshes and all."""
    assert layer.layer.col_chunk >= DIMS.d_inter       # the fixture: whole
    per_col = 2 * layer.ctx.L * layer.ctx.cfg.N * 8
    monkeypatch.setattr(bert, "LAYER_CHUNK_BYTES",
                        col_chunk * per_col + per_col // 2)
    got = build_layer(LOGN, LEVELS, DIMS, PLAN, INPUTS, device="cpu")
    assert got.layer.col_chunk == col_chunk
    res = got.fn(got.x_data)
    assert res.scale == out.scale and torch.equal(res.data, out.data)


def test_cpmm_column_slices_and_row_partials(layer):
    """Q/K/V by head and W_I by chunk (column slices), and W_F by chunk
    (row partial products summed before finish), against the whole CPMM."""
    ev, enc = layer.layer.ev, layer.layer.encoder
    rng = np.random.default_rng(5)
    J, I = 6, 10
    mask = bias_vec(layer.lens, DIMS.num_x, DIMS.num_row, ev.ctx.cfg.slots)
    mm = CPMM(ev, enc, rng.normal(0, 0.3, (J, I)), 12,
              bias=rng.normal(0, 0.1, I), mask=mask)
    c = Ciphertext(layer.x_data[:J, :, :12], layer.ctx.scale, True)
    whole = mm(c)
    for cols in (slice(0, 4), slice(4, 10), slice(7, 9)):
        assert torch.equal(mm(c, cols=cols).data, whole.data[cols])
    q = ev.dev["q"][:12].reshape(-1, 1)
    acc = None
    for rows in (slice(0, 4), slice(4, 6)):
        p = mm.product(c.with_data(c.data[rows]), rows=rows)
        acc = p if acc is None else (acc + p).remainder_(q)
    summed = mm.finish(acc, c.scale)
    assert summed.scale == whole.scale
    assert torch.equal(summed.data, whole.data)


def test_two_layer_model_matches_chained_oracle(layer):
    """EncryptedBertModel over two layers (calibrated together) against
    layer_oracle applied twice."""
    ws = [layer.weights, load_reference_layer(1, DIMS)]
    domains, max_table = calibrate_domains(layer.xs, layer.lens, ws, DIMS)
    inner = layer.layer
    model = EncryptedBertModel(inner.ev, inner.encoder, ws, DIMS, PLAN,
                               layer.lens, refresh=inner.refresh,
                               max_table=max_table, domains=domains)
    assert model.n_att == inner.n_att
    out = model(Ciphertext(layer.x_data, layer.ctx.scale, True))
    want = layer.xs
    for w, d, m in zip(ws, domains, max_table):
        want = layer_oracle(want, w, layer.lens, DIMS, PLAN, m, d)
    assert np.abs(layer.decode(out) - want).max() < TOL


def test_weights_and_references_match_jax(layer):
    """load_reference_layer (synthesized), plain_bert_layer and
    calibrate_domains equal the JAX package's; convert carries its weights
    over unchanged."""
    from moai_tpu.models import bert as jbert
    jdims = jbert.BertDims(**dataclasses.asdict(DIMS))
    for lid in (0, 1):
        jw = jbert.load_reference_layer(lid, jdims)
        w = load_reference_layer(lid, DIMS)
        for f in dataclasses.fields(w):
            assert np.array_equal(getattr(w, f.name), getattr(jw, f.name))
            assert np.array_equal(getattr(convert.bert_layer_weights(jw),
                                          f.name), getattr(jw, f.name))
    jw = jbert.load_reference_layer(0, jdims)
    x = layer.xs[0, :layer.lens[0]]
    assert np.array_equal(bert.plain_bert_layer(x, layer.weights, DIMS),
                          jbert.plain_bert_layer(x, jw, jdims))
    assert calibrate_domains(layer.xs, layer.lens, [layer.weights], DIMS) \
        == jbert.calibrate_domains(layer.xs, layer.lens, [jw], jdims)
    assert bert.galois_steps_for_model(DIMS) == \
        jbert.galois_steps_for_model(jdims)


def _attention_scale_flow(ctx, plan: DepthPlan) -> dict:
    """log2 scales along the layer's attention, as the ops' bookkeeping
    computes them (a rescale divides by the top pair of its level; CPMM,
    the exp's 1/2^r and the mask land where they start; the refresh of the
    sums re-encodes at ctx.scale)."""
    def pair(n):
        return math.log2(ctx.q_primes[n - 1]) + math.log2(ctx.q_primes[n - 2])
    sx = math.log2(ctx.scale)
    n_att = min(ctx.L, ctx.n_q0 + 2 * plan.attention_in + 4)
    n = n_att - 2                         # Q, K
    s = 2 * sx - pair(n)                  # QK^T
    n -= 4                                # QK^T rescale, exp's constant
    for _ in range(plan.exp_r):
        s = 2 * s - pair(n)
        n -= 2
    n -= 2                                # the mask
    n_e = n
    n_v = n_att - 2 * (1 + 1 + plan.softmax_pre + 1)
    n = min(ctx.L, n_v + 2 + 2 * (plan.inv_iters + 1))   # refreshed sum
    y = r = sx
    for _ in range(plan.inv_iters):       # Goldschmidt: y^2, res * (1+y)
        y = 2 * y - pair(n)
        n -= 2
        r = r + y - pair(n)
    n -= 2
    assert n == n_e == n_v + 2
    sm = s + r - pair(n_e)                # exp * inverse
    att = sm + sx - pair(n_v)             # softmax * V, then W_O
    return {"e": s - sx, "inverse": r - sx, "attention": att - sx}


def test_attention_scale_drift_at_the_chip_chain():
    """At the chip's chain (logN 15, L 28, the DepthPlan of
    tests/test_model.py) the composite-pair drift stays under a bit at every
    stage, so the JAX layer's own input scale is kept (the head's chain
    needed entry.balanced_input_scale); the W_O output decrypts at 4 primes
    (112 bits) far inside the window."""
    ctx = Context(head_config(15, 13), device="cpu")
    flow = _attention_scale_flow(
        ctx, DepthPlan(exp_r=5, inv_iters=5, ln_newton=2, ln_gold=0,
                       gelu_degree=16))
    assert max(abs(v) for v in flow.values()) < 1.0, flow


@pytest.mark.slow
def test_layer_bit_identical_to_jax(layer, out):
    """The whole layer against moai_tpu.models.bert.EncryptedBertLayer (run
    eagerly, as tests/test_model.py runs it), built as build_layer builds
    the port's: the same config, keys drawn from the same seed in the same
    order, the same weights, calibration and input, the JAX Recryptor."""
    from moai_tpu.params import CKKSConfig, make_context
    from moai_tpu.encoder import Encoder as JEncoder
    from moai_tpu.keys import KeyGenerator as JKeyGenerator
    from moai_tpu.encrypt import Encryptor as JEncryptor, \
        Decryptor as JDecryptor
    from moai_tpu.evaluator import Evaluator as JEvaluator
    from moai_tpu.models import bert as jbert
    from moai_tpu.ops.packing import batch_input as jbatch_input
    from moai_tpu.utils.recrypt import Recryptor as JRecryptor
    jctx = make_context(CKKSConfig(**dataclasses.asdict(
        head_config(LOGN, LEVELS))))
    jenc = JEncoder(jctx)
    jkg = JKeyGenerator(jctx, seed=11)
    jdims = jbert.BertDims(**dataclasses.asdict(DIMS))
    gks = jkg.gen_galois_keys(steps=jbert.galois_steps_for_model(jdims))
    jencryptor = JEncryptor(jctx, jenc, jkg.gen_public_key(), jkg)
    rec = JRecryptor(jencryptor, JDecryptor(jctx, jenc, jkg.sk))
    jev = JEvaluator(jctx, relin_key=jkg.gen_relin_key(), galois_keys=gks)
    dom = layer.domains
    jlayer = jbert.EncryptedBertLayer(
        jev, jenc, jbert.load_reference_layer(0, jdims), jdims,
        jbert.DepthPlan(**dataclasses.asdict(PLAN)), layer.lens,
        max_table=layer.max_val,
        refresh=lambda ct, n_q: rec.recrypt(ct, n_q=n_q),
        ln1_domain=dom["ln1"], ln2_domain=dom["ln2"],
        gelu_domain=dom["gelu"])
    x = jbatch_input(jencryptor, layer.xs, DIMS.num_x, DIMS.num_row,
                     n_q=jlayer.n_att)
    assert np.array_equal(np.asarray(x.data).astype(np.int64),
                          layer.x_data.numpy())
    want = jlayer(x)
    assert want.scale == out.scale
    assert np.array_equal(np.asarray(want.data).astype(np.int64),
                          out.data.numpy())
