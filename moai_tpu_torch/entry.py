"""The encrypted attention head, the encrypted encoder layer and the
bootstrap, end to end.

- ``build_head``: port of ``__graft_entry__._build_head``, one full
  encrypted attention head (Q/K/V CPMM -> QK^T CCMM -> polynomial softmax
  with an in-budget Goldschmidt inverse -> softmax*V CCMM) over an
  interleaved batch of ``num_x`` inputs of ``num_row`` tokens.
- ``build_lfm2_conv``: one chip's channel share of LFM2's gated
  short-convolution mixer (``models.lfm2.EncryptedShortConv``: in_proj
  CPMM, the two gating products, the causal token-shift conv, the
  row-parallel out_proj) over the same packing.
- ``build_layer``: one BERT encoder layer (``models.bert.
  EncryptedBertLayer``) on the harness Recryptor refresh, as
  ``tests/test_model.py`` builds the JAX one, with weights from
  ``load_reference_layer`` and domains from ``calibrate_domains``.
- ``build_model``: the stacked encoder (``models.bert.
  EncryptedBertModel``) on the same set-up, with layer-state checkpoints
  (``serial.save_layer_state``) and resume (``start_layer``).
- ``build_bootstrap``: the CKKS bootstrap (``boot.bootstrap``) through
  ``make_refresh``, as the layers call it, over a batch of ciphertexts
  whose slot values are the oracle (over a mesh:
  ``parallel.sharding.ShardedBootstrapper.make_refresh``).
- ``build_sharded_step`` and ``build_sharded_ccmm``: the JAX package's
  sharded programs (``tools/scaling_sweep.py``'s evaluator step,
  ``tools/multichip_dryrun.py``'s CCMM) on a mesh, beside the same
  program unsharded.
- ``build_sharded_head`` (``shard_head`` of a built ``Head``): the head
  over a ("col", "limb") mesh, the port of ``__graft_entry__.
  dryrun_multichip``, beside ``build_head``'s unsharded head.

``head_oracle`` and ``layer_oracle`` (chained by ``Model.oracle``) compute
the same functions, with the circuits' own polynomial approximations, in
float64 numpy.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from .boot.bootstrap import EVALMOD_DEGREE, Bootstrapper, make_refresh
from .ciphertext import Ciphertext
from .encoder import Encoder
from .encrypt import Encryptor, Decryptor
from .evaluator import Evaluator
from .keys import KeyGenerator
from .models import lfm2_reference
from .models.bert import (BertDims, BertLayerWeights, DepthPlan,
                          EncryptedBertLayer, EncryptedBertModel,
                          calibrate_domains, galois_steps_for_model,
                          load_reference_layer, plain_bert_layer)
from .models.lfm2 import LEVELS, EncryptedShortConv, Lfm2ConvDims
from .ops.matmul import (CPMM, ccmm_col_to_diag, ccmm_diag_to_col,
                         ccmm_col_steps, ccmm_diag_steps, col_chunk_for)
from .ops.nonlinear import (SoftmaxPts, softmax_diag, diag_valid_masks,
                            fit_gelu_cheb, fit_rsqrt_line)
from .ops.packing import batch_input, bias_vec, unpack_batch
from .ops.shortconv import shift_steps
from .params import CKKSConfig, Context, head_config, resolve_device
from .parallel.sharding import (Mesh, ShardedCiphertext, ShardedEvaluator,
                                ccmm_col_to_diag_sharded,
                                ccmm_diag_to_col_sharded, cpmm_sharded,
                                shard_ciphertext, softmax_diag_sharded)
from . import serial
from .utils import debug
from .utils.recrypt import Recryptor

MAX_VAL = 2.0           # softmax shift: scores enter exp as x - MAX_VAL
EPS = 1e-5              # added to the exp-sum before the inverse


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
    ev: Evaluator              # its keys: relinearization, both CCMMs' steps
    encoder: Encoder
    mms: tuple                 # the Q, K and V CPMMs
    masks: np.ndarray          # the softmax's diagonal masks
    n_v: int                   # the level of V and of the softmax output
    col_chunk: int             # the QK^T CCMM's column chunk
    x_scale: float             # the input's encoding scale
    pts: SoftmaxPts            # the softmax's plaintexts, encoded once

    def decode(self, out: Ciphertext) -> np.ndarray:
        """Decrypt the head output -> [input_count, num_row, head_dim]."""
        sm = self.decryptor.decrypt(out).real
        return unpack_batch(sm, self.num_x, self.num_row, len(self.lens))

    def oracle(self) -> np.ndarray:
        return head_oracle(self.xs, self.weights, self.lens, self.exp_r,
                           self.inv_iters, self.num_row)


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
    pts = SoftmaxPts(ev, enc, masks)

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

    @debug.spanned("head")
    def head_fn(x_data: torch.Tensor) -> Ciphertext:
        x = Ciphertext(x_data, x_scale, True)
        q = q_mm(x)
        k = k_mm(x)
        v = v_mm(ev.mod_drop_to(x, n_v + 2))
        qkt = ccmm_col_to_diag(ev, q, k, num_x, num_row, col_chunk=col_chunk)
        del q, k
        sm = softmax_diag(ev, enc, qkt, masks, max_val=MAX_VAL,
                          refresh=lambda ct: ct, inv_iters=inv_iters,
                          eps=EPS, out_n_q=n_v, exp_r=exp_r, pts=pts)
        del qkt
        return ccmm_diag_to_col(ev, sm, v, num_x, num_row)

    xs = rng.normal(0, 0.5, (input_count, num_row, d_model))
    x0 = batch_input(encryptor, xs, num_x, num_row, scale=x_scale, n_q=n_att)
    return Head(head_fn, x0.data, ctx,
                Decryptor(ctx, enc, kg.sk, device=dev), xs, dict(weights),
                np.asarray(lens), num_x, num_row, exp_r, inv_iters, ev, enc,
                (q_mm, k_mm, v_mm), masks, n_v, col_chunk, x_scale, pts)


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


@dataclasses.dataclass
class Lfm2Conv:
    fn: Callable[[torch.Tensor], Ciphertext]   # h data -> the share's y
    x_data: torch.Tensor       # encrypted h [hidden_size, 2, L, N]
    ctx: Context
    decryptor: Decryptor
    xs: np.ndarray             # plaintext h [input_count, num_row, H]
    weights: dict              # in_proj, conv, out_proj (nn layouts)
    lens: np.ndarray           # tokens per sequence
    dims: Lfm2ConvDims
    ev: Evaluator              # its keys: relinearization, the shifts
    mixer: EncryptedShortConv

    def decode(self, out: Ciphertext) -> np.ndarray:
        """Decrypt the share's y -> [input_count, num_row, hidden_size]."""
        sm = self.decryptor.decrypt(out).real
        return unpack_batch(sm, self.dims.num_x, self.dims.num_row,
                            len(self.lens))

    def oracle(self) -> np.ndarray:
        """The share's y from ``lfm2_reference.mixer`` in float64."""
        return lfm2_reference.mixer(self.xs, self.weights, self.lens,
                                    self.dims.channels).numpy()


def build_lfm2_conv(logN: int = 16, n_data_levels: int = LEVELS,
                    dims: Lfm2ConvDims = Lfm2ConvDims(),
                    input_count: int | None = None, seed: int = 11,
                    device="cuda", weights: dict | None = None) -> Lfm2Conv:
    """Keys, weights, plaintexts and the encrypted h of one channel share
    of LFM2's conv mixer, on ``head_config(logN, n_data_levels)``.

    From ``seed``: the client's keys (relinearization, and Galois keys for
    the conv's shifts only), the sequences' lengths U{num_row/2..num_row}
    and h ~ N(0, 1) [input_count, num_row, hidden_size] in
    ``lfm2_reference.inputs``'s order, and with ``weights=None`` the
    weights of ``lfm2_reference.weights``.  h is encrypted at ctx.scale on
    the whole chain; the mixer raises where the chain holds fewer than its
    ``LEVELS`` levels."""
    dev = resolve_device(device)
    ctx = Context(head_config(logN, n_data_levels), device=dev)
    if dims.num_x * dims.num_row != ctx.cfg.slots:
        raise ValueError(f"num_x*num_row = {dims.num_x * dims.num_row} != "
                         f"{ctx.cfg.slots} slots")
    input_count = dims.num_x if input_count is None else input_count
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=seed, device=dev)
    gks = kg.gen_galois_keys(steps=shift_steps(dims.num_x,
                                               dims.conv_L_cache))
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device=dev)
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), galois_keys=gks,
                   device=dev)
    lens, xs = lfm2_reference.inputs(seed, input_count, dims.num_row,
                                     dims.hidden_size, dims.num_row // 2,
                                     dims.num_row)
    if weights is None:
        weights = lfm2_reference.weights(seed, dims.hidden_size,
                                         dims.conv_L_cache)
    mixer = EncryptedShortConv(ev, enc, dims, weights, lens, ctx.L)
    x0 = batch_input(encryptor, xs, dims.num_x, dims.num_row, n_q=ctx.L)

    def lfm2_fn(x_data: torch.Tensor) -> Ciphertext:
        return mixer(Ciphertext(x_data, ctx.scale, True))

    return Lfm2Conv(lfm2_fn, x0.data, ctx,
                    Decryptor(ctx, enc, kg.sk, device=dev), xs, weights,
                    np.asarray(lens), dims, ev, mixer)


def _decode_layer_output(decryptor: Decryptor, ctx: Context,
                         dims: BertDims, n_inputs: int,
                         out: Ciphertext) -> np.ndarray:
    """Decrypt a layer output -> [n_inputs, num_row, d_model].

    Decrypts the bottom n_q0 + 1 limbs only: the centered message (|m| ~
    2^55 at LayerNorm scale) is far inside their product's half (2^85 at
    logN 15), so it is the integer decryption at every limb gives, and the
    host's CRT decode, which costs per limb, is ~9x shorter at the layer's
    28."""
    n_q = min(out.n_q, ctx.n_q0 + 1)
    low = out.with_data(out.data[..., :n_q, :])
    return unpack_batch(decryptor.decrypt(low).real, dims.num_x,
                        dims.num_row, n_inputs)


@dataclasses.dataclass
class Layer:
    fn: Callable[[torch.Tensor], Ciphertext]   # x data -> layer output
    x_data: torch.Tensor       # encrypted input [d_model, 2, n_att, N]
    ctx: Context
    decryptor: Decryptor
    layer: EncryptedBertLayer
    xs: np.ndarray             # plaintext input [input_count, num_row, d]
    weights: BertLayerWeights
    lens: np.ndarray           # valid tokens per input
    dims: BertDims
    plan: DepthPlan
    max_val: float             # the softmax shift (calibrated max table)
    domains: dict              # ln1, ln2 (S ranges) and gelu (half-width)
    setup_s: dict              # host seconds of the set-up, by part
    refresh_log: list          # per refresh: (batch shape, n_q, start on
    #                            time.perf_counter, seconds)

    def decode(self, out: Ciphertext) -> np.ndarray:
        """Decrypt the layer output -> [input_count, num_row, d_model]."""
        return _decode_layer_output(self.decryptor, self.ctx, self.dims,
                                    len(self.lens), out)

    def oracle(self) -> np.ndarray:
        return layer_oracle(self.xs, self.weights, self.lens, self.dims,
                            self.plan, self.max_val, self.domains)

    def plain(self) -> np.ndarray:
        """``plain_bert_layer`` on each input's valid tokens; rows past a
        length are 0."""
        out = np.zeros_like(self.xs)
        for j, n in enumerate(self.lens):
            out[j, :n] = plain_bert_layer(self.xs[j, :n], self.weights,
                                          self.dims)
        return out


@dataclasses.dataclass
class _EncoderSetup:
    """What ``build_layer`` and ``build_model`` share: the context, keys,
    the drawn input, the weights of layers [0, n_layers), their
    calibration and the Recryptor refresh."""
    ctx: Context
    encoder: Encoder
    encryptor: Encryptor
    decryptor: Decryptor
    ev: Evaluator
    dims: BertDims
    lens: np.ndarray
    xs: np.ndarray
    weights: list              # BertLayerWeights per layer
    domains: list              # calibrated domains per layer
    max_table: list            # calibrated softmax shift per layer
    refresh: Callable[[Ciphertext, int], Ciphertext]
    refresh_log: list
    t0: float                  # the set-up's start, time.perf_counter

    def encrypt_input(self, n_q: int) -> tuple[torch.Tensor, dict]:
        """The encrypted input at n_q limbs, and the set-up's seconds."""
        _sync(self.ctx.device)
        t1 = time.perf_counter()
        x0 = batch_input(self.encryptor, self.xs, self.dims.num_x,
                         self.dims.num_row, n_q=n_q)
        _sync(self.ctx.device)
        return x0.data, {"keys_weights": t1 - self.t0,
                         "encrypt": time.perf_counter() - t1}


def _encoder_setup(logN: int, n_data_levels: int, dims: BertDims,
                   input_count: int, n_layers: int, seed: int,
                   device) -> _EncoderSetup:
    """The context is ``head_config(logN, n_data_levels)``; keys, the
    input lengths (in [num_row/2, num_row]) and the N(0, 0.5) tokens are
    drawn from ``seed`` in ``build_head``'s order; the weights are
    ``load_reference_layer(i, dims)`` for i < n_layers.  The softmax max
    table and the LayerNorm and GELU domains come from one
    ``calibrate_domains`` call over this batch and every layer: a layer's
    entries depend only on that layer's input, so layer 0's are the same
    for any n_layers."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ctx = Context(head_config(logN, n_data_levels), device=dev)
    if dims.num_x * dims.num_row != ctx.cfg.slots:
        raise ValueError(f"num_x*num_row = {dims.num_x * dims.num_row} != "
                         f"{ctx.cfg.slots} slots")
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=seed, device=dev)
    gks = kg.gen_galois_keys(steps=galois_steps_for_model(dims))
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device=dev)
    decryptor = Decryptor(ctx, enc, kg.sk, device=dev)
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), galois_keys=gks,
                   device=dev)

    rng = np.random.default_rng(seed)
    lens = rng.integers(dims.num_row // 2, dims.num_row + 1,
                        size=input_count)
    xs = rng.normal(0, 0.5, (input_count, dims.num_row, dims.d_model))
    for j, n in enumerate(lens):
        xs[j, n:] = 0.0
    ws = [load_reference_layer(i, dims) for i in range(n_layers)]
    domains, max_table = calibrate_domains(xs, lens, ws, dims)
    rec = Recryptor(encryptor, decryptor)
    refresh_log = []

    def refresh(ct: Ciphertext, n_q: int) -> Ciphertext:
        _sync(dev)
        t = time.perf_counter()
        out = rec.recrypt(ct, n_q=n_q)
        _sync(dev)
        refresh_log.append((ct.batch_shape, n_q, t,
                            time.perf_counter() - t))
        return out

    return _EncoderSetup(ctx, enc, encryptor, decryptor, ev, dims,
                         np.asarray(lens), xs, ws, domains, max_table,
                         refresh, refresh_log, t0)


def build_layer(logN: int, n_data_levels: int, dims: BertDims,
                plan: DepthPlan, input_count: int, seed: int = 11,
                device="cuda") -> Layer:
    """Keys, weights, calibration and the encrypted input of one encoder
    layer on the harness Recryptor (``_encoder_setup`` with one layer).
    The input is encoded at ctx.scale, as the JAX layer's test encodes
    it."""
    s = _encoder_setup(logN, n_data_levels, dims, input_count, 1, seed,
                       device)
    ctx = s.ctx
    dom = s.domains[0]
    layer = EncryptedBertLayer(
        s.ev, s.encoder, s.weights[0], dims, plan, s.lens,
        max_table=s.max_table[0], refresh=s.refresh, ln1_domain=dom["ln1"],
        ln2_domain=dom["ln2"], gelu_domain=dom["gelu"])
    x_data, setup_s = s.encrypt_input(layer.n_att)

    def layer_fn(x_data: torch.Tensor) -> Ciphertext:
        return layer(Ciphertext(x_data, ctx.scale, True))

    return Layer(layer_fn, x_data, ctx, s.decryptor, layer, s.xs,
                 s.weights[0], s.lens, dims, plan, s.max_table[0], dom,
                 setup_s, s.refresh_log)


@dataclasses.dataclass
class Model:
    # (x data, start_layer=0, on_layer=None) -> the last layer's output;
    # on_layer(i, ct) is called after layer i
    fn: Callable[..., Ciphertext]
    x_data: torch.Tensor       # encrypted input [d_model, 2, n_att, N]
    ctx: Context
    decryptor: Decryptor
    model: EncryptedBertModel
    xs: np.ndarray             # plaintext input [input_count, num_row, d]
    weights: list              # BertLayerWeights per layer
    lens: np.ndarray           # valid tokens per input
    dims: BertDims
    plan: DepthPlan
    max_table: list            # the softmax shift per layer
    domains: list              # ln1, ln2 and gelu per layer
    setup_s: dict              # host seconds of the set-up, by part
    refresh_log: list          # as ``Layer.refresh_log``, every layer's

    def decode(self, out: Ciphertext) -> np.ndarray:
        """Decrypt a layer output -> [input_count, num_row, d_model]."""
        return _decode_layer_output(self.decryptor, self.ctx, self.dims,
                                    len(self.lens), out)

    def oracle(self, upto: int) -> np.ndarray:
        """``layer_oracle`` chained over layers [0, upto)."""
        out = self.xs
        for i in range(upto):
            out = layer_oracle(out, self.weights[i], self.lens, self.dims,
                               self.plan, self.max_table[i], self.domains[i])
        return out

    def save_state(self, path: str, ct: Ciphertext, i: int) -> None:
        """Checkpoint layer i's output (``serial.save_layer_state``)."""
        serial.save_layer_state(path, ct, i, self.ctx.cfg)

    def load_state(self, path: str) -> tuple[Ciphertext, int]:
        """-> (ciphertext on the model's device, layer index); resume with
        ``fn(ct.data, start_layer=index + 1)``."""
        return serial.load_layer_state(path, device=self.ctx.device)


def build_model(logN: int, n_data_levels: int, dims: BertDims,
                plan: DepthPlan, n_layers: int, input_count: int,
                seed: int = 11, device="cuda") -> Model:
    """The stacked encoder (``models.bert.EncryptedBertModel``) of
    ``n_layers`` layers on the harness Recryptor: the context, keys, input
    and its encryption are ``build_layer``'s for the same seed, so layer 0
    computes ``build_layer``'s layer on the same residues."""
    s = _encoder_setup(logN, n_data_levels, dims, input_count, n_layers,
                       seed, device)
    ctx = s.ctx
    model = EncryptedBertModel(s.ev, s.encoder, s.weights, dims, plan,
                               s.lens, refresh=s.refresh,
                               max_table=s.max_table, domains=s.domains)
    x_data, setup_s = s.encrypt_input(model.n_att)

    def model_fn(x_data: torch.Tensor, start_layer: int = 0,
                 on_layer: Callable[[int, Ciphertext], None] | None = None
                 ) -> Ciphertext:
        model.on_layer = on_layer
        try:
            return model(Ciphertext(x_data, ctx.scale, True), start_layer)
        finally:
            model.on_layer = None

    return Model(model_fn, x_data, ctx, s.decryptor, model, s.xs, s.weights,
                 s.lens, dims, plan, s.max_table, s.domains, setup_s,
                 s.refresh_log)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def layer_oracle(xs: np.ndarray, w: BertLayerWeights, lens, dims: BertDims,
                 plan: DepthPlan, max_val: float, domains: dict,
                 eps: float = EPS) -> np.ndarray:
    """The layer in float64 with the circuit's approximations, over every
    row (padding rows too, as the circuit computes them):
    - masked Q/K/V (rows past a length are 0) and the exp as
      (1 + x/2^r)^(2^r) on x = QK^T - max_val over valid entries, times
      the valid mask / num_row; the row sum plus eps/num_row; the
      Goldschmidt product prod_{i<=inv_iters} (1 + y^(2^i)), y = 1 - sum;
    - masked W_O, the residual, and LayerNorm in its S-domain form
      (d_j = C x_j - sum x, S = sum d_j^2, S scaled by 1/hi into the
      rsqrt's domain) with the rsqrt of ``layernorm``: fit_rsqrt_line, then
      ln_newton Newton and ln_gold Goldschmidt steps;
    - masked W_I, GELU as the Chebyshev fit of degree gelu_degree on
      [-domain, domain], masked W_F, the residual and LayerNorm again.
    Returns [input_count, num_row, d_model]."""
    R, hd, C = dims.num_row, dims.head_dim, dims.d_model
    r = 1 << plan.exp_r
    gelu_c = fit_gelu_cheb(domains["gelu"], plan.gelu_degree)

    def layernorm(v, gamma, beta, var_domain):
        lo, hi = var_domain
        d = C * v - v.sum(-1, keepdims=True)
        sn = (d * d).sum(-1, keepdims=True) / hi
        a, b = fit_rsqrt_line(lo / hi, 1.0)
        y = a * sn + b
        for _ in range(plan.ln_newton):
            y = y * (1.5 - 0.5 * sn * y * y)
        if plan.ln_gold:
            g, h = sn * y, 0.5 * y
            for _ in range(plan.ln_gold):
                r1 = 1.5 - g * h
                g, h = g * r1, h * r1
            y = 2 * h
        return d * y * gamma * np.sqrt(C / hi) + beta

    out = np.zeros(xs.shape[:2] + (C,))
    for j, n in enumerate(np.asarray(lens)):
        x = xs[j]
        m = (np.arange(R) < n).astype(np.float64)[:, None]
        valid = m * m.T
        q = (x @ w.wq / np.sqrt(hd) + w.bq / np.sqrt(hd)) * m
        k = (x @ w.wk + w.bk) * m
        v = (x @ w.wv + w.bv) * m
        heads = []
        for h in range(dims.num_heads):
            sl = slice(h * hd, (h + 1) * hd)
            e = (1.0 + (q[:, sl] @ k[:, sl].T - max_val * valid) / r) ** r
            e = e * valid / R
            y = 1.0 - (e.sum(1) + eps / R)
            inv = np.ones(R)
            for i in range(plan.inv_iters + 1):
                inv *= 1.0 + y ** (1 << i)
            heads.append((e * inv[:, None]) @ v[:, sl])
        att = (np.concatenate(heads, -1) @ w.wo + w.bo) * m
        h1 = layernorm(att + x, w.ln1_g, w.ln1_b, domains["ln1"])
        f = (h1 @ w.wi + w.bi) * m
        g = np.polynomial.chebyshev.chebval(f / domains["gelu"], gelu_c)
        f2 = (g @ w.wf + w.bf) * m
        out[j] = layernorm(f2 + h1, w.ln2_g, w.ln2_b, domains["ln2"])
    return out


@dataclasses.dataclass
class Bootstrap:
    fn: Callable[[torch.Tensor], Ciphertext]   # x data -> refreshed batch
    x_data: torch.Tensor       # encrypted input [batch, 2, n_q0 + 2, N]
    ctx: Context
    decryptor: Decryptor
    bootstrapper: Bootstrapper
    values: np.ndarray         # the input's slot values [batch, slots]
    n_out: int                 # output limbs: the full data chain
    setup_s: dict              # host seconds of the set-up, by part

    def decode(self, out: Ciphertext) -> np.ndarray:
        """Decrypt the bottom n_q0 + 2 limbs of a refreshed batch ->
        complex slots [batch, slots].  Dropping limbs leaves the message
        as it is and keeps the host's CRT decode short."""
        return self.decryptor.decrypt(
            out.with_data(out.data[..., :self.ctx.n_q0 + 2, :]))


def build_bootstrap(cfg: CKKSConfig, batch: int, seed: int = 11,
                    m_bound: float = 1.0, lt_group: int | None = None,
                    evalmod_degree: int = EVALMOD_DEGREE,
                    value_bound: float = 0.8, device="cuda") -> Bootstrap:
    """Context, keys, Bootstrapper and the encrypted input of a bootstrap
    pass over ``batch`` ciphertexts.

    Keys are drawn from ``seed`` in the order of the JAX package's own
    bootstrap tests (public key, relinearization key, then the Galois keys
    of ``Bootstrapper.galois_steps()`` with the conjugation), and held as
    int32, as every residue (29.3 GB of Galois keys at N = 2^16).  Each
    ciphertext carries its own U(-value_bound, value_bound) slot values,
    drawn from ``seed``, encrypted at ctx.scale on n_q0 + 2 limbs: one
    spare level above q0, as the layers keep at a refresh.  ``fn``
    refreshes the batch through ``make_refresh(bt, m_bound)`` up to
    ``n_out`` = L - 2 * bt.levels limbs, the data chain above the
    bootstrap's own levels."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ctx = Context(cfg, device=dev)
    enc = Encoder(ctx)
    t1 = time.perf_counter()
    kg = KeyGenerator(ctx, seed=seed, device=dev)
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device=dev)
    decryptor = Decryptor(ctx, enc, kg.sk, device=dev)
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), device=dev)
    t2 = time.perf_counter()
    bt = Bootstrapper(ev, enc, m_bound=m_bound, lt_group=lt_group,
                      evalmod_degree=evalmod_degree)
    t3 = time.perf_counter()
    ev.galois_keys = kg.gen_galois_keys(steps=bt.galois_steps(),
                                        conjugate=True)
    _sync(dev)
    t4 = time.perf_counter()
    n_out = ctx.L - 2 * bt.levels
    if n_out < ctx.n_q0 + 2:
        raise ValueError(f"chain too short: {ctx.L} primes, the bootstrap "
                         f"spends {2 * bt.levels}")
    refresh = make_refresh(bt, m_bound=m_bound)
    values = np.random.default_rng(seed).uniform(
        -value_bound, value_bound, (batch, cfg.slots))
    x = encryptor.encrypt_values(values, n_q=ctx.n_q0 + 2)
    _sync(dev)
    setup_s = {"context": t1 - t0, "keys": (t2 - t1) + (t4 - t3),
               "bootstrapper": t3 - t2,
               "encrypt": time.perf_counter() - t4}

    def boot_fn(x_data: torch.Tensor) -> Ciphertext:
        return refresh(Ciphertext(x_data, ctx.scale, True), n_out)

    return Bootstrap(boot_fn, x.data, ctx, decryptor, bt, values, n_out,
                     setup_s)


def evaluator_step(ev, a, b):
    """``tools/scaling_sweep.py``'s step: multiply, relinearize, rescale the
    pair, rotate by one slot.  ``ev`` is an ``Evaluator`` (a and b
    Ciphertexts) or a ``ShardedEvaluator`` (ShardedCiphertexts)."""
    return ev.rotate(ev.rescale_pair(ev.relinearize(ev.multiply(a, b))), 1)


def _shard_for(mesh: Mesh):
    """ct -> ShardedCiphertext: its batch over the mesh's ``col`` axis and
    its limbs over the ``limb`` axis, ``P("col", None, "limb", None)`` (on
    a mesh of one column, tools/scaling_sweep.py's ``P("col", None, None,
    None)``; on one row, ``P(None, None, "limb", None)``)."""
    return lambda ct: shard_ciphertext(ct, mesh, limb=True)


@dataclasses.dataclass
class ShardedStep:
    fn: Callable[[ShardedCiphertext, ShardedCiphertext], ShardedCiphertext]
    plain: Callable[[Ciphertext, Ciphertext], Ciphertext]   # unsharded
    shard: Callable[[Ciphertext], ShardedCiphertext]
    a: Ciphertext              # the inputs, unsharded, on the device
    b: Ciphertext
    ctx: Context
    sev: ShardedEvaluator
    mesh: Mesh


def build_sharded_step(cfg: CKKSConfig, batch: int, mesh: Mesh,
                       seed: int = 3, device="cuda") -> ShardedStep:
    """``tools/scaling_sweep.py``'s program on ``mesh``: keys drawn from
    ``seed`` in its order (the Galois key of rotation 1, the public key,
    the relinearization key), ``batch`` ciphertexts of U(-1, 1) slots from
    ``default_rng(0)`` and the same values reversed, at the full chain.
    ``fn`` runs ``evaluator_step`` on the sharded inputs, ``plain`` the
    same step unsharded on ``device``; ``shard`` places an input
    (``_shard_for``)."""
    dev = resolve_device(device)
    shard = _shard_for(mesh)
    ctx = Context(cfg, device=dev)
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=seed, device=dev)
    gks = kg.gen_galois_keys(steps=[1])
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device=dev)
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), galois_keys=gks,
                   device=dev)
    vals = np.random.default_rng(0).uniform(-1, 1, (batch, cfg.slots))
    a = encryptor.encrypt(encryptor.encode(vals))
    b = encryptor.encrypt(encryptor.encode(vals[::-1]))
    sev = ShardedEvaluator(ev, mesh)
    return ShardedStep(lambda x, y: evaluator_step(sev, x, y),
                       lambda x, y: evaluator_step(ev, x, y), shard, a, b,
                       ctx, sev, mesh)


@dataclasses.dataclass
class ShardedCCMM:
    fn: Callable[[ShardedCiphertext, ShardedCiphertext], ShardedCiphertext]
    plain: Callable[[Ciphertext, Ciphertext], Ciphertext]   # unsharded
    shard: Callable[[Ciphertext], ShardedCiphertext]
    x: Ciphertext              # the col-packed inputs [columns, 2, L, N]
    w: Ciphertext
    ctx: Context
    decryptor: Decryptor
    values: tuple              # the slot values of x and w
    num_x: int
    num_row: int


def build_sharded_ccmm(cfg: CKKSConfig, num_x: int, num_row: int,
                       columns: int, mesh: Mesh, seed: int = 7,
                       col_chunk: int | None = None,
                       device="cuda") -> ShardedCCMM:
    """``tools/multichip_dryrun.py``'s CCMM (``ccmm_col_to_diag``) on
    ``mesh`` (``ccmm_col_to_diag_sharded``; ``shard`` as in
    ``build_sharded_step``): keys from ``seed`` in its order (the Galois
    keys of ``ccmm_col_steps``, the public key, the relinearization key), X
    and W of ``columns`` ciphertexts of N(0, 0.5) slots from
    ``default_rng(5)`` at the full chain.  ``plain`` is the unsharded CCMM
    on ``device``."""
    dev = resolve_device(device)
    shard = _shard_for(mesh)
    ctx = Context(cfg, device=dev)
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=seed, device=dev)
    gks = kg.gen_galois_keys(steps=ccmm_col_steps(num_x, num_row))
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device=dev)
    decryptor = Decryptor(ctx, enc, kg.sk, device=dev)
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), galois_keys=gks,
                   device=dev)
    rng = np.random.default_rng(5)
    va = rng.normal(0, 0.5, (columns, cfg.slots))
    vb = rng.normal(0, 0.5, (columns, cfg.slots))
    x = encryptor.encrypt_values(va, n_q=ctx.L)
    w = encryptor.encrypt_values(vb, n_q=ctx.L)
    sev = ShardedEvaluator(ev, mesh)
    return ShardedCCMM(
        lambda a, b: ccmm_col_to_diag_sharded(sev, a, b, num_x, num_row,
                                              col_chunk),
        lambda a, b: ccmm_col_to_diag(ev, a, b, num_x, num_row,
                                      col_chunk=col_chunk),
        shard, x, w, ctx, decryptor, (va, vb), num_x, num_row)


@dataclasses.dataclass
class ShardedHead:
    fn: Callable[[torch.Tensor], ShardedCiphertext]   # x data -> output
    plain: Callable[[torch.Tensor], Ciphertext]        # the unsharded head
    head: Head
    sev: ShardedEvaluator
    mesh: Mesh


def shard_head(head: Head, mesh: Mesh) -> ShardedHead:
    """``head`` over ``mesh``: ``fn`` places the input at P("col", None,
    "limb", None) (``_shard_for``), runs the Q/K/V CPMMs
    (``cpmm_sharded``, their outputs' columns over col), QK^T
    (``ccmm_col_to_diag_sharded``), the softmax (``softmax_diag_sharded``,
    the identity refresh) and softmax x V (``ccmm_diag_to_col_sharded``)
    through one ``ShardedEvaluator``, and returns the output with its
    columns over col.  Every residue is the unsharded head's."""
    sev = ShardedEvaluator(head.ev, mesh)
    shard = _shard_for(mesh)
    q_mm, k_mm, v_mm = head.mms

    def fn(x_data: torch.Tensor) -> ShardedCiphertext:
        x = shard(Ciphertext(x_data, head.x_scale, True))
        q = cpmm_sharded(sev, q_mm, x)
        k = cpmm_sharded(sev, k_mm, x)
        v = cpmm_sharded(sev, v_mm, sev.mod_drop_to(x, head.n_v + 2))
        del x
        qkt = ccmm_col_to_diag_sharded(sev, q, k, head.num_x, head.num_row,
                                       head.col_chunk)
        del q, k
        sm = softmax_diag_sharded(sev, head.encoder, qkt, head.masks,
                                  max_val=MAX_VAL, refresh=lambda ct: ct,
                                  inv_iters=head.inv_iters, eps=EPS,
                                  out_n_q=head.n_v, exp_r=head.exp_r,
                                  pts=head.pts)
        del qkt
        return ccmm_diag_to_col_sharded(sev, sm, v, head.num_x,
                                        head.num_row)

    return ShardedHead(fn, head.fn, head, sev, mesh)


def build_sharded_head(logN: int, n_data_levels: int, num_x: int,
                       num_row: int, d_model: int, head_dim: int, exp_r: int,
                       inv_iters: int, input_count: int, mesh: Mesh,
                       seed: int = 11, device="cuda",
                       weights: dict | None = None,
                       nominal_input_scale: bool = False) -> ShardedHead:
    """``__graft_entry__.dryrun_multichip``'s program: ``build_head``'s
    head (the same keys, weights and input) over ``mesh`` (``shard_head``),
    beside it unsharded (``plain``).  With ``nominal_input_scale`` and
    ``_build_head``'s arguments and seed, every residue is the one its
    jitted sharded program computes."""
    head = build_head(logN, n_data_levels, num_x, num_row, d_model, head_dim,
                      exp_r, inv_iters, input_count, seed=seed, device=device,
                      weights=weights,
                      nominal_input_scale=nominal_input_scale)
    return shard_head(head, mesh)
