"""moai_tpu_torch scheme layer against moai_tpu at test_config(): context
tables, keys, fresh ciphertexts and evaluator ops are bit-identical, and
decryption agrees.  Both packages draw from the same seed in the same
order, so their keys and ciphertexts match; the evaluator ops run on
ciphertexts converted from the JAX package's."""

import numpy as np
import pytest
import torch

import jax

from moai_tpu.params import make_context, test_config as _jax_test_config
from moai_tpu.encoder import Encoder as JEncoder
from moai_tpu.keys import KeyGenerator as JKeyGenerator
from moai_tpu.encrypt import Encryptor as JEncryptor, Decryptor as JDecryptor
from moai_tpu.evaluator import Evaluator as JEvaluator
from moai_tpu.ciphertext import Ciphertext as JCiphertext
from moai_tpu_torch import convert
from moai_tpu_torch.params import Context, test_config as _test_config
from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.keys import KeyGenerator
from moai_tpu_torch.encrypt import Encryptor, Decryptor
from moai_tpu_torch.evaluator import Evaluator

torch.set_num_threads(1)
SEED = 5
RNG = np.random.default_rng(21)


def _jit(fn, *args):
    """jax.jit(fn)(*args), compiled without XLA's backend optimizations:
    the results are exact integers at any optimization level, and the
    compile is shorter."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _build(ctx, enc, kg, make_enc, make_ev, make_dec):
    """Both packages' objects, drawn in _build_head's order."""
    n = ctx.cfg.slots
    gks = kg.gen_galois_keys(steps=[1, 2, 4, n - 1])
    pk = kg.gen_public_key()
    encryptor = make_enc(pk)
    relin = kg.gen_relin_key()
    return dict(kg=kg, gks=gks, pk=pk, relin=relin, enc=encryptor,
                ev=make_ev(relin, gks), dec=make_dec())


@pytest.fixture(scope="module")
def both():
    jctx = make_context(_jax_test_config())
    jenc = JEncoder(jctx)
    jkg = JKeyGenerator(jctx, seed=SEED)
    j = _build(jctx, jenc, jkg, lambda pk: JEncryptor(jctx, jenc, pk, jkg),
               lambda r, g: JEvaluator(jctx, relin_key=r, galois_keys=g),
               lambda: JDecryptor(jctx, jenc, jkg.sk))
    ctx = Context(_test_config(), device="cpu")
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=SEED, device="cpu")
    t = _build(ctx, enc, kg,
               lambda pk: Encryptor(ctx, enc, pk, kg, device="cpu"),
               lambda r, g: Evaluator(ctx, relin_key=r, galois_keys=g,
                                      device="cpu"),
               lambda: Decryptor(ctx, enc, kg.sk, device="cpu"))
    vals = RNG.uniform(-1, 1, (2, 2, ctx.cfg.slots))
    j["ct"] = j["enc"].encrypt_values(vals)
    t["ct"] = t["enc"].encrypt_values(vals)
    return jctx, j, ctx, t, vals


def _eq(a, b):
    return np.array_equal(np.asarray(a).astype(np.int64),
                          np.asarray(b).astype(np.int64))


TABLES = ["resc_qlinv_mont", "resc_half", "resc_half_mod",
          "pdown_hatinv_mont", "pdown_hat_modq_mm", "pdown_pinv_mont",
          "pdown_half", "pdown_half_modq", "ks_hatinv_mont", "ks_hat_mm",
          "ks_q_pad", "ks_qneg_pad"]
NTT_TABLES = ["q", "qneg_inv", "r2", "r1", "psi_pl", "psi_sh", "psiinv_n_pl",
              "psiinv_n_sh", "w_mid_pl", "w_mid_sh", "w_mid_inv_pl",
              "w_mid_inv_sh"]


def test_context_chain(both):
    jctx, _, ctx, _, _ = both
    for k in ("q_primes", "p_primes", "all_primes", "digit_ranges", "L", "K",
              "n_q0", "dnum", "alpha", "sp_slice", "scale", "q0_product",
              "P_int"):
        assert getattr(ctx, k) == getattr(jctx, k), k


@pytest.mark.parametrize("name", TABLES)
def test_context_rns_tables(both, name):
    jctx, _, ctx, _, _ = both
    assert _eq(getattr(ctx, name), getattr(jctx, name))


@pytest.mark.parametrize("name", NTT_TABLES)
def test_context_ntt_tables(both, name):
    jctx, _, ctx, _, _ = both
    assert _eq(getattr(ctx.ntt, name), getattr(jctx.ntt, name))
    for n in (ctx.ntt.n1, ctx.ntt.n2):
        for a, b in zip(ctx.ntt.stage_tw[n] + ctx.ntt.stage_tw_inv[n],
                        jctx.ntt.stage_tw[n] + jctx.ntt.stage_tw_inv[n]):
            assert _eq(a, b)


def test_keys_identical(both):
    _, j, _, t, _ = both
    assert _eq(t["kg"].sk.coeffs, j["kg"].sk.coeffs)
    assert _eq(t["kg"].sk.s_ntt, j["kg"].sk.s_ntt)
    assert _eq(t["pk"].data, j["pk"].data)
    assert _eq(t["relin"].data, j["relin"].data)
    assert list(t["gks"].keys) == list(j["gks"].keys)
    for g in j["gks"].keys:
        assert _eq(t["gks"].keys[g].data, j["gks"].keys[g].data)
        assert _eq(t["gks"].perms[g], j["gks"].perms[g])


def test_convert_carries_keys_and_plaintexts(both):
    _, j, _, t, vals = both
    assert torch.equal(convert.secret_key(j["kg"].sk, device="cpu").s_ntt,
                       t["kg"].sk.s_ntt)
    assert torch.equal(convert.public_key(j["pk"], device="cpu").data,
                       t["pk"].data)
    assert torch.equal(convert.kswitch_key(j["relin"], device="cpu").data,
                       t["relin"].data)
    gks = convert.galois_keys(j["gks"], device="cpu")
    for g, k in t["gks"].keys.items():
        assert torch.equal(gks.keys[g].data, k.data)
        assert np.array_equal(gks.perms[g], t["gks"].perms[g])
    jpt, pt = j["enc"].encode(vals[0]), t["enc"].encode(vals[0])
    cpt = convert.plaintext(jpt, device="cpu")
    assert cpt.scale == pt.scale and torch.equal(cpt.data, pt.data)


def test_fresh_ciphertexts_identical(both):
    _, j, _, t, _ = both
    assert t["ct"].scale == j["ct"].scale
    assert _eq(t["ct"].data, j["ct"].data)


def test_decrypt_agrees(both):
    _, j, _, t, vals = both
    res = t["dec"].decrypt_to_residues(t["ct"])
    assert _eq(res, j["dec"].decrypt_to_residues(j["ct"]))
    got = t["dec"].decrypt(t["ct"])
    assert np.array_equal(got, j["dec"].decrypt(j["ct"]))
    assert np.abs(got.real - vals).max() < 1e-6


def _jit_op(j, name, *args):
    """(data, scale) of a JAX evaluator op on j["ct"], jitted."""
    ev = j["ev"]
    scale = j["ct"].scale

    def fn(d):
        return getattr(ev, name)(JCiphertext(d, scale), *args)

    out = _jit(fn, j["ct"].data)
    return out.data, out.scale


@pytest.mark.parametrize("op,args", [
    ("rotate", (1,)), ("rotate", (3,)), ("rotate_hoisted", ([1, 2, 4],)),
    ("rescale_pair", ())])
def test_unary_ops_identical(both, op, args):
    _, j, _, t, _ = both
    want, want_scale = _jit_op(j, op, *args)
    got = getattr(t["ev"], op)(convert.ciphertext(j["ct"], device="cpu"),
                                 *args)
    assert got.scale == want_scale
    assert _eq(got.data, want)


def test_multiply_relinearize_identical(both):
    _, j, _, t, _ = both
    jev, tev = j["ev"], t["ev"]
    a, b = j["ct"], JCiphertext(j["ct"].data[::-1], j["ct"].scale)
    jm = _jit(lambda x, y: jev.multiply(JCiphertext(x, a.scale),
                                        JCiphertext(y, a.scale)).data,
              a.data, b.data)
    tm = tev.multiply(convert.ciphertext(a, device="cpu"),
                      convert.ciphertext(b, device="cpu"))
    assert _eq(tm.data, jm)
    jr = _jit(lambda x: jev.relinearize(JCiphertext(x, tm.scale)).data, jm)
    tr = tev.relinearize(tm)
    assert _eq(tr.data, jr)
    assert _eq(tev.rescale_pair(tr).data,
               _jit(lambda x: jev.rescale_pair(
                   JCiphertext(x, tm.scale)).data, jr))
