"""moai_tpu_torch.serial against moai_tpu.serial, and the stacked encoder's
checkpoints (entry.build_model).

Files: the logN-9 chain of tests/test_serial.py; both packages draw their
keys and ciphertext from one seed in one order, so they hold the same
residues.  Every kind round-trips in the port (switching keys as int64 and
int32), a file written by either package loads into the other with equal
arrays, and a reloaded secret key decrypts within 1e-4.

Checkpoints: ``build_model`` at the tiny dims of tests/test_torch_layer.py,
two layers.  Its refresh is the Recryptor, which draws fresh randomness,
so a resumed run matches the uninterrupted one when it resumes where the
first run stopped: layer 0, ``save_state`` and a stop, then ``load_state``
and ``fn(start_layer=1)``.  The slow tests hold the model bit-identical to
``moai_tpu.models.bert.EncryptedBertModel`` over the JAX Recryptor, and
resume the port from a checkpoint the JAX model wrote."""

import dataclasses
import zipfile

import numpy as np
import pytest
import torch

from moai_tpu import serial as jserial
from moai_tpu.encoder import Encoder as JEncoder
from moai_tpu.encrypt import Encryptor as JEncryptor, Decryptor as JDecryptor
from moai_tpu.keys import KeyGenerator as JKeyGenerator
from moai_tpu.params import CKKSConfig as JCKKSConfig, make_context
from moai_tpu_torch import serial
from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.encrypt import Encryptor, Decryptor
from moai_tpu_torch.entry import build_layer, build_model
from moai_tpu_torch.keys import GaloisKeys, KeyGenerator, KSwitchKey, \
    slice_kswitch
from moai_tpu_torch.models.bert import BertDims, DepthPlan
from moai_tpu_torch.params import CKKSConfig, Context, head_config

torch.set_num_threads(1)
CFG = dict(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
           n_data_levels=4, n_boot_levels=0, dnum=2, hamming_weight=32)
STEPS = [1, -2]
# the model: tests/test_torch_layer.py's layer, stacked twice
DIMS = BertDims(num_x=32, num_row=8, d_model=8, num_heads=2, head_dim=4,
                d_inter=16)
PLAN = DepthPlan(exp_r=2, inv_iters=2, ln_newton=1, ln_gold=0,
                 gelu_degree=8)
LOGN, LEVELS, INPUTS, LAYERS = 9, 10, 3, 2
TOL = 1e-8                      # tests/test_torch_layer.py's oracle bound


def _draw(kg, make_encryptor, vals):
    """Keys, a plaintext and its encryption in tests/test_serial.py's
    order."""
    out = dict(kg=kg, pk=kg.gen_public_key(), rk=kg.gen_relin_key(),
               gks=kg.gen_galois_keys(steps=STEPS, conjugate=True))
    encryptor = make_encryptor(out["pk"])
    out["pt"] = encryptor.encode(vals[None])
    out["ct"] = encryptor.encrypt(out["pt"])
    return out


@pytest.fixture(scope="module")
def both():
    vals = np.random.default_rng(1).uniform(-1, 1, 1 << (CFG["logN"] - 1))
    jctx = make_context(JCKKSConfig(**CFG))
    jenc = JEncoder(jctx)
    jkg = JKeyGenerator(jctx, seed=9)
    j = _draw(jkg, lambda pk: JEncryptor(jctx, jenc, pk, jkg), vals)
    j.update(ctx=jctx, enc=jenc)
    ctx = Context(CKKSConfig(**CFG), device="cpu")
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=9, device="cpu")
    t = _draw(kg, lambda pk: Encryptor(ctx, enc, pk, kg, device="cpu"),
              vals)
    t.update(ctx=ctx, enc=enc)
    return j, t, vals


def _eq(a, b) -> bool:
    """Equal residues, whatever each side's container and dtype."""
    def host(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return x.astype(np.int64)
    return np.array_equal(host(a), host(b))


@pytest.mark.parametrize("group", ["scheme", "keys", "galois"])
def test_port_round_trips(both, tmp_path, group):
    """Every kind, saved and loaded by the port: the same residues in the
    dtype asked for.  A key sliced to a prefix of the chain loads back
    with q_limbs None: the format saves ``data`` only."""
    _, t, _ = both
    ctx = t["ctx"]
    p = str(tmp_path / "f.bin")
    if group == "scheme":
        serial.save_config(p, ctx.cfg)
        assert serial.load_context(p, device="cpu").all_primes == \
            ctx.all_primes
        for save, load, obj in (
                (serial.save_ciphertext, serial.load_ciphertext, t["ct"]),
                (serial.save_plaintext, serial.load_plaintext, t["pt"])):
            save(p, obj)
            got = load(p, device="cpu")
            assert (got.scale, got.is_ntt) == (obj.scale, obj.is_ntt)
            assert got.data.dtype == torch.int64
            assert torch.equal(got.data, obj.data)
        serial.save_layer_state(p, t["ct"], 3, ctx.cfg)
        got, idx = serial.load_layer_state(p, device="cpu")
        assert idx == 3 and got.scale == t["ct"].scale
        assert torch.equal(got.data, t["ct"].data)
    elif group == "keys":
        sk = t["kg"].sk
        serial.save_secret_key(p, sk)
        got = serial.load_secret_key(p, device="cpu")
        assert np.array_equal(got.coeffs, sk.coeffs)
        assert torch.equal(got.s_ntt, sk.s_ntt)
        serial.save_public_key(p, t["pk"])
        assert torch.equal(serial.load_public_key(p, device="cpu").data,
                           t["pk"].data)
        rk32 = KSwitchKey(t["rk"].data.to(torch.int32))
        for key, dtype in ((t["rk"], torch.int64), (rk32, torch.int32),
                           (rk32, torch.int64)):
            serial.save_kswitch_key(p, key)
            got = serial.load_kswitch_key(p, device="cpu", dtype=dtype)
            assert got.data.dtype == dtype and got.q_limbs is None
            assert torch.equal(got.data.long(), t["rk"].data)
        cut = slice_kswitch(t["rk"], 5, ctx.L)
        serial.save_kswitch_key(p, cut)
        got = serial.load_kswitch_key(p, device="cpu")
        assert cut.q_limbs == 5 and got.q_limbs is None
        assert torch.equal(got.data, cut.data)
    else:
        gks = t["gks"]
        gks32 = GaloisKeys({g: KSwitchKey(k.data.to(torch.int32))
                            for g, k in gks.keys.items()}, gks.perms)
        for keys, dtype in ((gks, torch.int64), (gks32, torch.int32),
                            (gks32, torch.int64)):
            serial.save_galois_keys(p, keys)
            got = serial.load_galois_keys(p, device="cpu", dtype=dtype)
            assert sorted(got.keys) == sorted(gks.keys)
            for g, k in gks.keys.items():
                assert got.keys[g].data.dtype == dtype
                assert torch.equal(got.keys[g].data.long(), k.data)
                assert np.array_equal(got.perms[g], gks.perms[g])


def _save_all(mod, d, side, cfg) -> dict:
    """Every kind, written by one package (``mod``) into directory d."""
    paths = {k: str(d / f"{k}.bin") for k in
             ("cfg", "ct", "pt", "sk", "pk", "rk", "gk", "state")}
    mod.save_config(paths["cfg"], cfg)
    mod.save_ciphertext(paths["ct"], side["ct"], cfg)
    mod.save_plaintext(paths["pt"], side["pt"])
    mod.save_secret_key(paths["sk"], side["kg"].sk)
    mod.save_public_key(paths["pk"], side["pk"])
    mod.save_kswitch_key(paths["rk"], side["rk"])
    mod.save_galois_keys(paths["gk"], side["gks"])
    mod.save_layer_state(paths["state"], side["ct"], 1, cfg)
    return paths


def _assert_loaded(loaded: dict, side: dict):
    """Objects loaded from _save_all's files hold ``side``'s residues."""
    for k in ("ct", "pt"):
        assert loaded[k].scale == side[k].scale
        assert loaded[k].is_ntt == side[k].is_ntt
        assert _eq(loaded[k].data, side[k].data)
    state, idx = loaded["state"]
    assert idx == 1 and _eq(state.data, side["ct"].data)
    assert np.array_equal(loaded["sk"].coeffs, side["kg"].sk.coeffs)
    assert _eq(loaded["sk"].s_ntt, side["kg"].sk.s_ntt)
    assert _eq(loaded["pk"].data, side["pk"].data)
    assert _eq(loaded["rk"].data, side["rk"].data)
    assert sorted(loaded["gk"].keys) == sorted(side["gks"].keys)
    for g, k in side["gks"].keys.items():
        assert _eq(loaded["gk"].keys[g].data, k.data)
        assert np.array_equal(loaded["gk"].perms[g], side["gks"].perms[g])


def _load_all(mod, paths: dict, **kw) -> dict:
    return {"ctx": mod.load_context(paths["cfg"], **kw),
            "ct": mod.load_ciphertext(paths["ct"], **kw),
            "pt": mod.load_plaintext(paths["pt"], **kw),
            "sk": mod.load_secret_key(paths["sk"], **kw),
            "pk": mod.load_public_key(paths["pk"], **kw),
            "rk": mod.load_kswitch_key(paths["rk"], **kw),
            "gk": mod.load_galois_keys(paths["gk"], **kw),
            "state": mod.load_layer_state(paths["state"], **kw)}


def test_jax_files_load_into_port(both, tmp_path):
    """Deflated files of the JAX package load into the port with the JAX
    residues, which are the port's own; the reloaded secret key
    decrypts."""
    j, t, vals = both
    paths = _save_all(jserial, tmp_path, j, JCKKSConfig(**CFG))
    with zipfile.ZipFile(paths["ct"]) as z:
        assert z.getinfo("data.npy").compress_type == zipfile.ZIP_DEFLATED
    got = _load_all(serial, paths, device="cpu")
    assert got["ctx"].all_primes == t["ctx"].all_primes
    _assert_loaded(got, j)
    _assert_loaded(got, t)
    dec = Decryptor(t["ctx"], t["enc"], got["sk"], device="cpu")
    assert np.abs(dec.decrypt(got["ct"]).real[0] - vals).max() < 1e-4


def test_port_files_load_into_jax(both, tmp_path):
    """The port's stored (uncompressed) files load into the JAX package
    with equal arrays; the reloaded secret key decrypts there."""
    j, t, vals = both
    paths = _save_all(serial, tmp_path, t, t["ctx"].cfg)
    for p in paths.values():
        with zipfile.ZipFile(p) as z:
            assert all(i.compress_type == zipfile.ZIP_STORED
                       for i in z.infolist())
    got = _load_all(jserial, paths)
    assert got["ctx"].all_primes == j["ctx"].all_primes
    _assert_loaded(got, j)
    dec = JDecryptor(j["ctx"], j["enc"], got["sk"])
    assert np.abs(dec.decrypt(got["ct"]).real[0] - vals).max() < 1e-4


class _Stop(Exception):
    """Ends a model run after its first checkpoint."""


def _run_to_checkpoint(model, path: str) -> tuple:
    """Layer 0, its state saved, then a stop; -> the reloaded state."""
    def save_and_stop(i, ct):
        model.save_state(path, ct, i)
        raise _Stop
    with pytest.raises(_Stop):
        model.fn(model.x_data, on_layer=save_and_stop)
    return model.load_state(path)


def _model():
    return build_model(LOGN, LEVELS, DIMS, PLAN, LAYERS, INPUTS,
                       device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    whole = _model()
    outs = {}
    out = whole.fn(whole.x_data,
                   on_layer=lambda i, ct: outs.setdefault(i, ct))
    part = _model()
    state, idx = _run_to_checkpoint(
        part, str(tmp_path_factory.mktemp("ckpt") / "layer0.zip"))
    resumed = part.fn(state.data, start_layer=idx + 1)
    return dict(whole=whole, out=out, layer0=outs[0], state=state, idx=idx,
                resumed=resumed)


def test_resume_equals_uninterrupted_run(runs):
    m = runs["whole"]
    assert runs["idx"] == 0 and runs["state"].scale == m.ctx.scale
    assert torch.equal(runs["state"].data, runs["layer0"].data)
    assert runs["resumed"].scale == runs["out"].scale
    assert torch.equal(runs["resumed"].data, runs["out"].data)
    assert len(m.refresh_log) == 7 * LAYERS
    assert np.abs(m.decode(runs["layer0"]) - m.oracle(1)).max() < TOL
    assert np.abs(m.decode(runs["out"]) - m.oracle(2)).max() < TOL


def test_start_layer_outside_range_raises(runs):
    m = runs["whole"]
    for bad in (-1, LAYERS + 1):
        with pytest.raises(ValueError, match="start_layer"):
            m.fn(m.x_data, start_layer=bad)
    assert m.fn(m.x_data, start_layer=LAYERS).data is m.x_data


def test_model_layer0_is_build_layer(runs):
    """One calibration over both layers gives layer 0 the domains of a
    calibration over layer 0 alone: the model's first layer is
    build_layer's, residue for residue."""
    m = runs["whole"]
    layer = build_layer(LOGN, LEVELS, DIMS, PLAN, INPUTS, device="cpu")
    assert torch.equal(layer.x_data, m.x_data)
    assert (layer.max_val, layer.domains) == (m.max_table[0], m.domains[0])
    out = layer.fn(layer.x_data)
    assert out.scale == runs["layer0"].scale
    assert torch.equal(out.data, runs["layer0"].data)


@pytest.fixture(scope="module")
def jax_model(runs, tmp_path_factory):
    """The JAX EncryptedBertModel built as build_model builds the port's
    (config, keys from the same seed in the same order, weights,
    calibration, input, the JAX Recryptor), run eagerly over both layers,
    its on_layer writing layer 0's state with moai_tpu.serial."""
    from moai_tpu.evaluator import Evaluator as JEvaluator
    from moai_tpu.models import bert as jbert
    from moai_tpu.ops.packing import batch_input as jbatch_input
    from moai_tpu.utils.recrypt import Recryptor as JRecryptor
    m = runs["whole"]
    cfg = JCKKSConfig(**dataclasses.asdict(head_config(LOGN, LEVELS)))
    jctx = make_context(cfg)
    jenc = JEncoder(jctx)
    jkg = JKeyGenerator(jctx, seed=11)
    jdims = jbert.BertDims(**dataclasses.asdict(DIMS))
    gks = jkg.gen_galois_keys(steps=jbert.galois_steps_for_model(jdims))
    jencryptor = JEncryptor(jctx, jenc, jkg.gen_public_key(), jkg)
    rec = JRecryptor(jencryptor, JDecryptor(jctx, jenc, jkg.sk))
    jev = JEvaluator(jctx, relin_key=jkg.gen_relin_key(), galois_keys=gks)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "layer0.zip")

    def on_layer(i, ct):
        if i == 0:
            jserial.save_layer_state(path, ct, i, cfg)

    model = jbert.EncryptedBertModel(
        jev, jenc, [jbert.load_reference_layer(i, jdims)
                    for i in range(LAYERS)], jdims,
        jbert.DepthPlan(**dataclasses.asdict(PLAN)), m.lens,
        refresh=lambda ct, n_q: rec.recrypt(ct, n_q=n_q),
        max_table=m.max_table, domains=m.domains, on_layer=on_layer)
    x = jbatch_input(jencryptor, m.xs, DIMS.num_x, DIMS.num_row,
                     n_q=model.n_att)
    assert _eq(x.data, m.x_data)
    return model(x), path


@pytest.mark.slow
def test_model_bit_identical_to_jax(runs, jax_model):
    want, _ = jax_model
    assert want.scale == runs["out"].scale
    assert _eq(want.data, runs["out"].data)


@pytest.mark.slow
def test_resume_from_jax_checkpoint(jax_model, tmp_path):
    """The port resumes from the JAX model's layer-0 checkpoint to the JAX
    model's output.  It first runs its own layer 0 to a checkpoint, which
    brings its Recryptor's random stream to where the JAX one stood."""
    want, path = jax_model
    m = _model()
    own, _ = _run_to_checkpoint(m, str(tmp_path / "own.zip"))
    state, idx = m.load_state(path)
    assert idx == 0 and torch.equal(state.data, own.data)
    got = m.fn(state.data, start_layer=idx + 1)
    assert got.scale == want.scale and _eq(got.data, want.data)
