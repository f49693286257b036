"""moai_tpu_torch encrypted matmuls against moai_tpu at test_config():
the modular int8-digit matmul, CPMM (with bias, with mask), and both CCMMs
(col->diag with and without column chunks, diag->col) are bit-identical on
ciphertexts converted from the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moai_tpu.params import make_context, test_config as _jax_test_config
from moai_tpu.encoder import Encoder as JEncoder
from moai_tpu.keys import KeyGenerator as JKeyGenerator
from moai_tpu.encrypt import Encryptor as JEncryptor
from moai_tpu.evaluator import Evaluator as JEvaluator
from moai_tpu.ciphertext import Ciphertext as JCiphertext
from moai_tpu import modmat as jmodmat
from moai_tpu.ops import matmul as jmm
from moai_tpu.ops.packing import batch_input as jbatch_input
from moai_tpu_torch import convert, modmat
from moai_tpu_torch import mod_arith as ma
from moai_tpu_torch.params import Context, test_config as _test_config
from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.keys import KeyGenerator
from moai_tpu_torch.evaluator import Evaluator
from moai_tpu_torch.ops import matmul as tmm
from moai_tpu_torch.ops.packing import bias_vec
from moai_tpu_torch.primes import ntt_primes_near

torch.set_num_threads(1)
RNG = np.random.default_rng(17)
NUM_X, NUM_ROW, NUM_INPUTS = 128, 8, 3
SEED = 5


def _jit(fn, *args):
    """jax.jit(fn)(*args), compiled without XLA's backend optimizations:
    the results are exact integers at any optimization level, and the
    compile is shorter."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


@pytest.fixture(scope="module")
def both():
    steps = sorted(set(tmm.ccmm_col_steps(NUM_X, NUM_ROW)
                       + tmm.ccmm_diag_steps(NUM_X, NUM_ROW)))
    assert steps == sorted(set(jmm.ccmm_col_steps(NUM_X, NUM_ROW)
                               + jmm.ccmm_diag_steps(NUM_X, NUM_ROW)))
    jctx = make_context(_jax_test_config())
    jenc = JEncoder(jctx)
    jkg = JKeyGenerator(jctx, seed=SEED)
    jgks = jkg.gen_galois_keys(steps=steps)
    jencryptor = JEncryptor(jctx, jenc, jkg.gen_public_key(), jkg)
    jrelin = jkg.gen_relin_key()
    jev = JEvaluator(jctx, relin_key=jrelin, galois_keys=jgks)
    ctx = Context(_test_config(), device="cpu")
    ev = Evaluator(ctx, relin_key=convert.kswitch_key(jrelin, device="cpu"),
                   galois_keys=convert.galois_keys(jgks, device="cpu"),
                   device="cpu")
    return jctx, jenc, jencryptor, jev, ctx, Encoder(ctx), ev


def _eq(a, b):
    return np.array_equal(np.asarray(a).astype(np.int64),
                          np.asarray(b).astype(np.int64))


def _enc_batch(jencryptor, d):
    xs = RNG.uniform(-1, 1, (NUM_INPUTS, NUM_ROW, d))
    return jbatch_input(jencryptor, xs, NUM_X, NUM_ROW)


def test_mod_matmul_exact():
    qs = ntt_primes_near(29.0, 2 ** 12, 3)
    J, I, N = 37, 5, 64
    x = np.stack([RNG.integers(0, q, size=(J, 2, N)) for q in qs], axis=-2)
    w = RNG.integers(0, 1 << 30, size=(len(qs), J, I), dtype=np.uint32)
    c = [ma.mont_constants(q) for q in qs]
    bm, bo = jmodmat.host_bucket_consts(qs)
    want = jmodmat.mod_matmul(
        jnp.asarray(x.astype(np.uint32)),
        jnp.asarray(jmodmat.host_weight_digits(w)), jnp.asarray(bm),
        jnp.asarray(bo), jnp.asarray(np.array(qs, np.uint32)),
        jnp.asarray(np.array([k["qneg_inv"] for k in c], np.uint32)))
    got = modmat.mod_matmul(
        torch.from_numpy(x), torch.from_numpy(modmat.host_weight_digits(w)),
        torch.from_numpy(modmat.host_bucket_consts(qs)),
        torch.tensor(qs), torch.tensor([k["rinv"] for k in c]))
    assert _eq(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_cpmm_identical(both, masked):
    jctx, jenc, jencryptor, jev, ctx, enc, ev = both
    J, I = 12, 6
    W = RNG.uniform(-1, 1, (J, I))
    bias = RNG.uniform(-1, 1, I)
    mask = bias_vec([NUM_ROW, 5, 3], NUM_X, NUM_ROW, ctx.cfg.slots) \
        if masked else None
    jct = _enc_batch(jencryptor, J)
    jmm_ = jmm.CPMM(jev, jenc, W, n_q=jctx.L, bias=bias, mask=mask)
    want = _jit(lambda d: jmm_(JCiphertext(d, jct.scale)), jct.data)
    got = tmm.CPMM(ev, enc, W, n_q=ctx.L, bias=bias, mask=mask)(
        convert.ciphertext(jct, device="cpu"))
    assert got.scale == want.scale and got.n_q == ctx.L - 2
    assert _eq(got.data, want.data)


@pytest.fixture(scope="module")
def col_to_diag_ref(both):
    """JAX inputs and output of one col->diag CCMM, shared by the chunked
    and unchunked comparisons."""
    jctx, jenc, jencryptor, jev, ctx, enc, ev = both
    cx, cw = _enc_batch(jencryptor, 5), _enc_batch(jencryptor, 5)
    want = _jit(lambda a, b: jmm.ccmm_col_to_diag(
        jev, JCiphertext(a, cx.scale), JCiphertext(b, cw.scale), NUM_X,
        NUM_ROW), cx.data, cw.data)
    return cx, cw, want


@pytest.mark.parametrize("col_chunk", [None, 2])
def test_ccmm_col_to_diag_identical(both, col_to_diag_ref, col_chunk):
    ev = both[-1]
    cx, cw, want = col_to_diag_ref
    got = tmm.ccmm_col_to_diag(ev, convert.ciphertext(cx, device="cpu"),
                               convert.ciphertext(cw, device="cpu"), NUM_X,
                               NUM_ROW,
                               col_chunk=col_chunk)
    assert got.scale == want.scale and got.data.shape[0] == NUM_ROW
    assert _eq(got.data, want.data)


def test_ccmm_diag_to_col_identical(both):
    jctx, jenc, jencryptor, jev, ctx, enc, ev = both
    ca = jencryptor.encrypt(jencryptor.encode(
        RNG.uniform(-1, 1, (NUM_ROW, ctx.cfg.slots))))
    cv = _enc_batch(jencryptor, 4)
    want = _jit(lambda a, b: jmm.ccmm_diag_to_col(
        jev, JCiphertext(a, ca.scale), JCiphertext(b, cv.scale), NUM_X,
        NUM_ROW), ca.data, cv.data)
    got = tmm.ccmm_diag_to_col(ev, convert.ciphertext(ca, device="cpu"),
                               convert.ciphertext(cv, device="cpu"), NUM_X,
                               NUM_ROW)
    assert got.scale == want.scale
    assert _eq(got.data, want.data)
