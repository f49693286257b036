"""moai_tpu_torch's polynomial nonlinearities at logN 9 on the head's chain
(34 primes): the Chebyshev evaluators, the monomial ladder, both rsqrts,
GELU (Chebyshev and sign-composite) and LayerNorm (whole, and in column
chunks).

- Tier 1: each decrypted result is held to the same function in float64
  numpy, which repeats the circuit's approximation, so what remains is
  CKKS noise at scale 2^52 (~1e-10 on values of order 1) times the
  function's amplification; each tolerance is that, rounded up to a power
  of ten.  The host fits equal the JAX package's, and LayerNorm in column
  chunks gives the residues it gives whole.
- Each function gives residues bit-identical to the JAX function
  (jitted, as the JAX package's own CPU tests run it) on the same
  ciphertexts, encrypted by the JAX package and carried over with
  ``convert``: in tier 1 for a degree-8 ``cheb_eval_bsgs`` and a chunked
  4-column ``layernorm``, in the slow tier for every other case.  XLA's
  compiles of the JAX functions are the cost: one to three minutes per
  case.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.special import erf

from moai_tpu.ops import nonlinear as jnl
from moai_tpu_torch import convert
from moai_tpu_torch.boot import evalmod
from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.encrypt import Decryptor, Encryptor
from moai_tpu_torch.evaluator import Evaluator
from moai_tpu_torch.keys import KeyGenerator
from moai_tpu_torch.minimax import fit_sign_composite, remez_fit
from moai_tpu_torch.ops import nonlinear as nl
from moai_tpu_torch.params import Context, head_config

torch.set_num_threads(1)
SEED = 7
CFG = head_config(logN=9, n_data_levels=16)
CHEB_C = np.random.default_rng(3).normal(0, 0.5, 6)
POLY_C = np.array([0.1, -0.5, 0.0, 0.25, 0.3, 0.0, -0.2])
SIGN = fit_sign_composite(0.2, [7, 7])[0]


def _slots(seed, lo, hi, rows=2):
    return np.random.default_rng(seed).uniform(lo, hi, (rows, CFG.slots))


def _rsqrt_line(x, domain, newton, gold):
    a, b = nl.fit_rsqrt_line(*domain)
    y = a * x + b
    for _ in range(newton):
        y = y * (1.5 - 0.5 * x * y * y)
    if gold:
        g, h = x * y, 0.5 * y
        for _ in range(gold):
            r = 1.5 - g * h
            g, h = g * r, h * r
        y = 2 * h
    return y


def _rsqrt_cheb(x):
    y = np.polynomial.chebyshev.chebval((2 * x - 1.02) / 0.98,
                                        nl.fit_rsqrt_cheb(0.02, 1.0, 7))
    for _ in range(2):
        y = y * (1.5 - 0.5 * x * y * y)
    return y


def _sign(x):
    for p in SIGN:
        x = np.polynomial.chebyshev.chebval(x, p)
    return x


def _gelu_sign(x, b=3.5, ib=8.0):
    polys = fit_sign_composite(min(0.5 / ib, b / ib / 4), [5, 5])[0]
    mid = remez_fit(lambda u: 0.5 * u * b * (1 + erf(u * b / np.sqrt(2))),
                    [(-1.0, 1.0)], 6)[0]

    def sgn(u):
        for p in polys:
            u = np.polynomial.chebyshev.chebval(u, p)
        return u
    s0, s1 = sgn(x / ib + b / ib), sgn(x / ib - b / ib)
    A = np.polynomial.chebyshev.chebval(x / b, mid)
    return A * (s0 - s1) / 2 + x * (1 + s1) / 2


def _ln_inputs(seed=11, C=12):
    """Columns of per-slot spread in [0.6, 1]: S = C^3 var then spans a
    ratio of ~3 (the linear rsqrt init diverges past ~20)."""
    xs = _slots(seed, -1, 1, C)
    rng = np.random.default_rng(seed + 1)
    xs = (xs - xs.mean(0)) / xs.std(0) * rng.uniform(0.6, 1.0, CFG.slots) \
        + rng.uniform(-0.3, 0.3, CFG.slots)
    gamma, beta = rng.uniform(0.5, 1.5, C), rng.uniform(-0.5, 0.5, C)
    d = C * xs - xs.sum(0)
    S = (d * d).sum(0)
    return xs, gamma, beta, (0.8 * S.min(), 1.05 * S.max())


def _ln_want(xs, gamma, beta, dom, newton=2, gold=1):
    C = xs.shape[0]
    d = C * xs - xs.sum(0)
    rs = _rsqrt_line((d * d).sum(0) / dom[1], (dom[0] / dom[1], 1.0),
                     newton, gold)
    return gamma[:, None] * d * rs * np.sqrt(C / dom[1]) + beta[:, None]


LN = _ln_inputs()
LN4 = _ln_inputs(C=4)

# name: (slot values, fn(module, ev, ct) with module the port's or the
# JAX package's nonlinear module, float64 function of the values, tolerance)
CASES = {
    "cheb_eval": (_slots(1, -1, 1),
                  lambda m, ev, ct: m.cheb_eval(ev, ct, CHEB_C),
                  lambda x: np.polynomial.chebyshev.chebval(x, CHEB_C), 1e-8),
    "cheb_eval_bsgs_16": (
        _slots(2, -1, 1),
        lambda m, ev, ct: m.cheb_eval_bsgs(ev, ct, nl.fit_gelu_cheb(5.0, 16)),
        lambda x: np.polynomial.chebyshev.chebval(
            x, nl.fit_gelu_cheb(5.0, 16)), 1e-7),
    "poly_eval": (_slots(3, -1, 1),
                  lambda m, ev, ct: m.poly_eval(ev, ct, POLY_C),
                  lambda x: np.polynomial.polynomial.polyval(x, POLY_C),
                  1e-8),
    "invert_sqrt": (_slots(4, 0.3, 1.0),
                    lambda m, ev, ct: m.invert_sqrt(ev, ct, (0.3, 1.0), 2, 1),
                    lambda x: _rsqrt_line(x, (0.3, 1.0), 2, 1), 1e-7),
    "invert_sqrt_cheb": (
        _slots(5, 0.02, 1.0),
        lambda m, ev, ct: m.invert_sqrt_cheb(ev, ct, (0.02, 1.0), 7, 2),
        _rsqrt_cheb, 1e-6),
    "gelu": (_slots(6, -4.5, 4.5),
             lambda m, ev, ct: m.gelu(ev, ct, domain=5.0, degree=16),
             lambda x: np.polynomial.chebyshev.chebval(
                 x / 5.0, nl.fit_gelu_cheb(5.0, 16)), 1e-7),
    "sign_composite": (_slots(8, 0.2, 1.0) * np.sign(_slots(9, -1, 1)),
                       lambda m, ev, ct: m.sign_composite(ev, ct, SIGN),
                       _sign, 1e-7),
    "gelu_sign": (_slots(10, -4.0, 4.0),
                  lambda m, ev, ct: m.gelu_sign(ev, ct, input_bound=8.0,
                                                degrees=(5, 5), mid_degree=6),
                  _gelu_sign, 1e-6),
    "layernorm": (LN[0],
                  lambda m, ev, ct: m.layernorm(ev, ct, *LN[1:], 2, 1),
                  lambda x: _ln_want(x, *LN[1:]), 1e-6),
    "layernorm_chunked": (
        LN[0], lambda m, ev, ct: m.layernorm(ev, ct, *LN[1:], 2, 1,
                                             col_chunk=4),
        lambda x: _ln_want(x, *LN[1:]), 1e-6),
    # the two small cases whose JAX comparison is in tier 1
    "cheb_eval_bsgs_8": (
        _slots(2, -1, 1, rows=1),
        lambda m, ev, ct: m.cheb_eval_bsgs(ev, ct, nl.fit_gelu_cheb(5.0, 8)),
        lambda x: np.polynomial.chebyshev.chebval(
            x, nl.fit_gelu_cheb(5.0, 8)), 1e-7),
    "layernorm_4_chunked": (
        LN4[0], lambda m, ev, ct: m.layernorm(ev, ct, *LN4[1:], 1, 0,
                                              col_chunk=3),
        lambda x: _ln_want(x, *LN4[1:], newton=1, gold=0), 1e-6),
}
# the Chebyshev evaluators live in boot.evalmod in both packages
BOOT = {"cheb_eval", "cheb_eval_bsgs_16", "cheb_eval_bsgs_8"}
# held bit-identical to the jitted JAX function in tier 1: XLA's compile
# of the JAX function is the cost, ~100 s and ~70 s on a CPU core with a
# cold compile cache; the other cases take 46-181 s each and are
# slow-tier.  Run eagerly instead, the JAX package compiles every op at
# every shape, and the two took over 15 minutes
TIER1_JAX = ["cheb_eval_bsgs_8", "layernorm_4_chunked"]


@pytest.fixture(scope="module")
def port():
    ctx = Context(CFG, device="cpu")
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=SEED, device="cpu")
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device="cpu")
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), device="cpu")
    return encryptor, ev, Decryptor(ctx, enc, kg.sk, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_numpy(port, name):
    vals, fn, want, tol = CASES[name]
    encryptor, ev, dec = port
    out = fn(evalmod if name in BOOT else nl, ev,
             encryptor.encrypt_values(vals))
    got = dec.decrypt(out).real
    assert np.abs(got - want(vals)).max() < tol


def test_approximations_hold():
    """The approximations the cases repeat are what they claim to be."""
    x = _slots(4, 0.3, 1.0)
    assert np.abs(_rsqrt_line(x, (0.3, 1.0), 2, 1) * np.sqrt(x) - 1).max() \
        < 1e-2
    x = _slots(5, 0.02, 1.0)
    assert np.abs(_rsqrt_cheb(x) * np.sqrt(x) - 1).max() < 2e-3
    xs = LN[0]
    exact = LN[1][:, None] * (xs - xs.mean(0)) / xs.std(0) + LN[2][:, None]
    assert np.abs(_ln_want(xs, *LN[1:]) - exact).max() < 3e-2
    x = _slots(8, 0.2, 1.0) * np.sign(_slots(9, -1, 1))
    assert np.abs(_sign(x) - np.sign(x)).max() < 1e-2


@pytest.mark.parametrize("col_chunk", [1, 4, 5])
def test_layernorm_chunks_identical(port, col_chunk):
    encryptor, ev, _ = port
    ct = encryptor.encrypt_values(LN[0])
    whole = nl.layernorm(ev, ct, *LN[1:], 2, 1)
    part = nl.layernorm(ev, ct, *LN[1:], 2, 1, col_chunk=col_chunk)
    assert part.scale == whole.scale
    assert torch.equal(part.data, whole.data)


@pytest.mark.parametrize("fit, args", [
    ("fit_rsqrt_line", (0.13, 1.0)), ("fit_rsqrt_cheb", (0.02, 1.0, 7)),
    ("fit_gelu_cheb", (5.0, 16)), ("fit_gelu_coeffs", (6.0, 16))])
def test_host_fits_match_jax(fit, args):
    assert np.array_equal(getattr(nl, fit)(*args), getattr(jnl, fit)(*args))


@pytest.fixture(scope="module")
def jax_keys():
    from moai_tpu.params import CKKSConfig, make_context
    from moai_tpu.encoder import Encoder as JEncoder
    from moai_tpu.keys import KeyGenerator as JKeyGenerator
    from moai_tpu.encrypt import Encryptor as JEncryptor
    from moai_tpu.evaluator import Evaluator as JEvaluator
    jctx = make_context(CKKSConfig(**dataclasses.asdict(CFG)))
    jkg = JKeyGenerator(jctx, seed=SEED)
    jencryptor = JEncryptor(jctx, JEncoder(jctx), jkg.gen_public_key(), jkg)
    jrelin = jkg.gen_relin_key()
    ev = Evaluator(Context(CFG, device="cpu"),
                   relin_key=convert.kswitch_key(jrelin, device="cpu"),
                   device="cpu")
    return jencryptor, JEvaluator(jctx, relin_key=jrelin), ev


def _jit(fn, *args):
    """jax.jit(fn)(*args), compiled without XLA's backend optimizations:
    the results are exact integers at any optimization level, and the
    compile is shorter."""
    import jax
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _assert_bit_identical(jax_keys, name):
    import jax
    from moai_tpu.boot import evalmod as jevalmod
    from moai_tpu.ciphertext import Ciphertext as JCiphertext
    vals, fn, _, _ = CASES[name]
    jencryptor, jev, ev = jax_keys
    jct = jencryptor.encrypt_values(vals)

    def jfn(d):
        return fn(jevalmod if name in BOOT else jnl, jev,
                  JCiphertext(d, jct.scale, True))
    want = _jit(jfn, jct.data)
    got = fn(evalmod if name in BOOT else nl, ev,
             convert.ciphertext(jct, device="cpu"))
    assert got.scale == want.scale and got.n_q == want.n_q
    assert np.array_equal(got.data.numpy(),
                          np.asarray(want.data).astype(np.int64))


@pytest.mark.parametrize("name", TIER1_JAX)
def test_small_cases_bit_identical_to_jax(jax_keys, name):
    _assert_bit_identical(jax_keys, name)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(set(CASES) - set(TIER1_JAX)))
def test_bit_identical_to_jax(jax_keys, name):
    _assert_bit_identical(jax_keys, name)
