"""moai_tpu_torch.parallel.sharding against moai_tpu.parallel.sharding on
the JAX tests' 8 virtual CPU devices (tests/conftest.py) and a mesh of 8 x
"cpu" in the port: every position's index ranges equal JAX's
``NamedSharding.devices_indices_map``; ``tools/scaling_sweep.py``'s
evaluator step, sharded on col, on limb and on both, gives the JAX
package's jitted sharded step bit for bit; so does the CCMM with its
columns sharded, and the port's CCMM sharded on both axes.  The slow
tests hold the bootstrap batch sharded on (col, limb) against
``tools/multichip_dryrun.py``'s, and ``make_refresh`` on meshes against
``make_refresh`` unsharded."""

import copy

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from moai_tpu.ciphertext import Ciphertext as JCiphertext
from moai_tpu.encoder import Encoder as JEncoder
from moai_tpu.encrypt import Encryptor as JEncryptor
from moai_tpu.evaluator import Evaluator as JEvaluator
from moai_tpu.keys import KeyGenerator as JKeyGenerator
from moai_tpu.params import CKKSConfig as JConfig, make_context
from moai_tpu.parallel import sharding as jsh
from moai_tpu_torch.ciphertext import Ciphertext
from moai_tpu_torch.entry import (build_bootstrap, build_sharded_ccmm,
                                  build_sharded_step, evaluator_step)
from moai_tpu_torch.keys import GaloisKeys, KSwitchKey
from moai_tpu_torch.params import CKKSConfig, Context
from moai_tpu_torch.parallel.sharding import (
    ShardedBootstrapper, ShardedEvaluator, ct_sharding, gather, make_mesh,
    replicated, shard_ciphertext)

torch.set_num_threads(1)
# tools/scaling_sweep.py's chain at logN 9: L 16, K 8
STEP_CFG = dict(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                n_data_levels=7, n_boot_levels=0, dnum=2, hamming_weight=64)
BATCH = 8
NUM_X, NUM_ROW = 64, 4          # logN 9: 256 slots
# (devices, limb axis) of each sharding
MESHES = {"col": (8, 1), "limb": (8, 8), "col_limb": (8, 2)}
SPECS = {"col": P("col", None, None, None), "limb": P(None, None, "limb", None),
         "col_limb": P("col", None, "limb", None)}


def _jit(fn, shardings, *args):
    """jax.jit(fn, in_shardings=...)(*args), compiled without XLA's backend
    optimizations: the results are exact integers at any optimization
    level, and the compile is shorter."""
    return jax.jit(fn, in_shardings=shardings).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})(*args)


def _cpu_mesh(n, limb_axis):
    return make_mesh(n, limb_axis=limb_axis, devices=["cpu"] * n)


def _eq(a, b):
    return np.array_equal(np.asarray(a).astype(np.int64),
                          np.asarray(b).astype(np.int64))


def _jax_map(jsharding, shape):
    """JAX's devices_indices_map keyed by mesh position."""
    devs = jsharding.mesh.devices
    return {tuple(int(v) for v in np.argwhere(devs == d)[0]): idx
            for d, idx in jsharding.devices_indices_map(shape).items()}


@pytest.mark.parametrize("mode", list(MESHES))
def test_placement_matches_jax(mode):
    n, la = MESHES[mode]
    jmesh, mesh = jsh.make_mesh(n, limb_axis=la), _cpu_mesh(n, la)
    assert np.shape(jmesh.devices) == (mesh.shape["col"], mesh.shape["limb"])
    data = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 30, (8, 2, 16, 32)).astype(np.int32))
    for batched in (True, False):
        x = data if batched else data[0]
        for limb in (False, True):
            want = _jax_map(jsh.ct_sharding(jmesh, batched, limb), x.shape)
            assert ct_sharding(mesh, batched, limb).devices_indices_map(
                x.shape) == want
            sct = shard_ciphertext(Ciphertext(x, 1.0), mesh, limb=limb)
            for pos, idx in want.items():
                assert sct.indices(pos) == idx
                assert torch.equal(sct.shards[pos].data, x[idx])
            assert torch.equal(gather(sct, "cpu").data, x)
    shape = (8, 2, 16, 32)
    assert replicated(mesh).devices_indices_map(shape) == \
        _jax_map(jsh.replicated(jmesh), shape)
    # a limb count that does not divide the limb axis: both refuse it
    if la > 1:
        bad = (8, 2, 7, 32)
        with pytest.raises(ValueError, match="evenly divide the shape"):
            jsh.ct_sharding(jmesh, True, True).devices_indices_map(bad)
        with pytest.raises(ValueError, match="evenly divide the shape"):
            shard_ciphertext(Ciphertext(torch.zeros(bad, dtype=torch.int32),
                                        1.0), mesh, limb=True)


def test_mesh_and_replicas():
    """make_mesh's JAX order, its refusals, replicas that are the object
    itself on its own device, and the sharded ops' refusal of a batch
    placed whole on each position of a limb axis of 2."""
    mesh = _cpu_mesh(8, 2)
    assert mesh.shape == {"col": 4, "limb": 2} and mesh.positions()[1] == (0, 1)
    assert mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="9 devices asked for"):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(6, limb_axis=4, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2, devices=["cuda:0", "cuda:0"])
    else:
        with pytest.raises(RuntimeError, match="present"):
            make_mesh(torch.cuda.device_count() + 1)
    st = build_sharded_step(CKKSConfig(**STEP_CFG), 2, mesh=_cpu_mesh(1, 1),
                            device="cpu")
    ev = st.sev.base
    assert ev.to("cpu") is ev and ev.ctx.to("cpu") is ev.ctx
    assert ev.relin_key.to("cpu") is ev.relin_key
    assert ev.galois_keys.to("cpu") is ev.galois_keys
    assert st.sev.ev((0, 0)) is ev
    sev = ShardedEvaluator(ev, _cpu_mesh(2, 2))
    x = shard_ciphertext(st.a, sev.mesh)
    assert torch.equal(gather(x, "cpu").data, st.a.data)
    for op in (lambda: sev.add(x, x), lambda: sev.rotate_hoisted(x, [1])):
        with pytest.raises(ValueError, match="placed whole"):
            op()


@pytest.fixture(scope="module")
def jax_step():
    """tools/scaling_sweep.py's objects at STEP_CFG and BATCH, its step."""
    ctx = make_context(JConfig(**STEP_CFG))
    enc = JEncoder(ctx)
    kg = JKeyGenerator(ctx, seed=3)
    gks = kg.gen_galois_keys(steps=[1])
    encryptor = JEncryptor(ctx, enc, kg.gen_public_key(), kg)
    ev = JEvaluator(ctx, relin_key=kg.gen_relin_key(), galois_keys=gks)
    vals = np.random.default_rng(0).uniform(-1, 1, (BATCH, ctx.cfg.slots))
    a = encryptor.encrypt(encryptor.encode(vals))
    b = encryptor.encrypt(encryptor.encode(vals[::-1]))

    def step(ad, bd):
        ca = JCiphertext(ad, ctx.scale, True)
        cb = JCiphertext(bd, ctx.scale, True)
        out = ev.rescale_pair(ev.relinearize(ev.multiply(ca, cb)))
        return ev.rotate(out, 1).data
    return a, b, step


@pytest.mark.parametrize("mode", list(MESHES))
def test_step_bit_identical_to_jax(jax_step, mode):
    ja, jb, step = jax_step
    n, la = MESHES[mode]
    sh = NamedSharding(jsh.make_mesh(n, limb_axis=la), SPECS[mode])
    want = _jit(step, (sh, sh), jax.device_put(ja.data, sh),
                jax.device_put(jb.data, sh))
    st = build_sharded_step(CKKSConfig(**STEP_CFG), BATCH, _cpu_mesh(n, la),
                            device="cpu")
    assert _eq(st.a.data, ja.data) and _eq(st.b.data, jb.data)
    out = st.fn(st.shard(st.a), st.shard(st.b))
    if mode != "col":               # two rescales left the limbs ragged
        assert out.limbs[-1][1] - out.limbs[-1][0] < \
            out.limbs[0][1] - out.limbs[0][0]
    got = gather(out, "cpu")
    assert got.data.dtype == torch.int32 and _eq(got.data, want)
    assert torch.equal(got.data, st.plain(st.a, st.b).data)
    if mode != "col":
        # on the keys' own device each limb shard read its rows in place
        assert st.sev._key_rows == {}
        _step_with_keys_elsewhere(st, got)


class _Elsewhere:
    """A key's data as a mesh on other devices than the key's sees it: a
    limb shard then reads its rows from one copy of them."""
    device = torch.device("meta")

    def __init__(self, t):
        self.t = t

    def __getitem__(self, idx):
        return self.t[idx]


def _step_with_keys_elsewhere(st, want):
    """The limb-sharded step of ``st`` again, its keys as if on another
    device: equal to ``want``, with one copy per key and position of the
    position's Q rows and all K special rows."""
    ev = copy.copy(st.sev.base)
    ev.relin_key = KSwitchKey(_Elsewhere(ev.relin_key.data))
    gks = ev.galois_keys
    ev.galois_keys = GaloisKeys({g: KSwitchKey(_Elsewhere(k.data))
                                 for g, k in gks.keys.items()}, gks.perms)
    sev = ShardedEvaluator(ev, st.mesh)
    got = gather(evaluator_step(sev, st.shard(st.a), st.shard(st.b)), "cpu")
    assert torch.equal(got.data, want.data)
    L, K = st.ctx.L, st.ctx.K
    rows = L // st.mesh.shape["limb"]
    assert {k[0] for k in sev._key_rows} == {"relin", *gks.keys}
    assert all(t.shape[-2] == e - s + K and e - s == rows
               for (_, _, s, e), t in sev._key_rows.items())


def test_ccmm_col_sharded_bit_identical_to_jax():
    """The double-BSGS CCMM with 4 columns over a (2, 1) mesh, one column
    per chunk: the port's per-shard partials, reduced and finished on the
    first position, and over a (2, 2) mesh with the limbs split too, give
    the unsharded port's residues and those of the JAX package's
    ccmm_col_to_diag jitted with its columns sharded (GSPMD's psum)."""
    from moai_tpu.ops.matmul import ccmm_col_steps, ccmm_col_to_diag
    cfg = CKKSConfig(**STEP_CFG)
    cc = build_sharded_ccmm(cfg, NUM_X, NUM_ROW, 4, _cpu_mesh(2, 1),
                            col_chunk=1, device="cpu")
    got = gather(cc.fn(cc.shard(cc.x), cc.shard(cc.w)), "cpu")
    want = cc.plain(cc.x, cc.w)
    assert got.scale == want.scale and torch.equal(got.data, want.data)
    # the same CCMM with its columns and limbs sharded on a (2, 2) mesh
    both = build_sharded_ccmm(cfg, NUM_X, NUM_ROW, 4, _cpu_mesh(4, 2),
                              col_chunk=1, device="cpu")
    assert torch.equal(gather(both.fn(both.shard(both.x),
                                      both.shard(both.w)), "cpu").data,
                       want.data)

    ctx = make_context(JConfig(**STEP_CFG))
    kg = JKeyGenerator(ctx, seed=7)
    gks = kg.gen_galois_keys(steps=ccmm_col_steps(NUM_X, NUM_ROW))
    encryptor = JEncryptor(ctx, JEncoder(ctx), kg.gen_public_key(), kg)
    ev = JEvaluator(ctx, relin_key=kg.gen_relin_key(), galois_keys=gks)
    a = encryptor.encrypt_values(cc.values[0], n_q=ctx.L)
    b = encryptor.encrypt_values(cc.values[1], n_q=ctx.L)
    assert _eq(cc.x.data, a.data) and _eq(cc.w.data, b.data)
    sh = jsh.ct_sharding(jsh.make_mesh(2), batched=True)
    jout = _jit(lambda x, w: ccmm_col_to_diag(
        ev, JCiphertext(x, a.scale), JCiphertext(w, b.scale), NUM_X,
        NUM_ROW).data, (sh, sh), jax.device_put(a.data, sh),
        jax.device_put(b.data, sh))
    assert _eq(got.data, jout)


# tools/multichip_dryrun.py's bootstrap chain at logN 9: L 38, K 12
BOOT_CFG = dict(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                n_data_levels=18, n_boot_levels=0, dnum=3, special_bits=29.5,
                hamming_weight=64)


@pytest.mark.slow
def test_bootstrap_batch_sharded_vs_jax():
    """tools/multichip_dryrun.py's boot program at logN 9: 4 ciphertexts
    (lt_group 3, the JAX package's EvalMod degree 59) with the
    ciphertexts placed (col, limb) and the keys limb-sharded on a (2, 2)
    mesh, in both packages: bit-identical.  The JAX bootstrap runs eagerly
    on its sharded arrays (each op partitioned by GSPMD): compiled whole,
    as tools/multichip_dryrun.py compiles it, XLA took over 46 GB at logN
    9 on four devices."""
    from moai_tpu.boot.bootstrap import Bootstrapper as JBootstrapper
    from moai_tpu_torch.boot.bootstrap import Bootstrapper
    from moai_tpu_torch.encoder import Encoder
    from moai_tpu_torch.encrypt import Encryptor
    from moai_tpu_torch.evaluator import Evaluator
    from moai_tpu_torch.keys import KeyGenerator

    jctx = make_context(JConfig(**BOOT_CFG))
    jenc = JEncoder(jctx)
    jkg = JKeyGenerator(jctx, seed=9)
    jencryptor = JEncryptor(jctx, jenc, jkg.gen_public_key(), jkg)
    jev = JEvaluator(jctx, relin_key=jkg.gen_relin_key())
    jbt = JBootstrapper(jev, jenc, lt_group=3)
    jev.galois_keys = jkg.gen_galois_keys(steps=jbt.galois_steps(),
                                          conjugate=True)
    jmesh = jsh.make_mesh(4, limb_axis=2)
    ksh = NamedSharding(jmesh, P(None, None, "limb", None))
    jev.relin_key.data = jax.device_put(jev.relin_key.data, ksh)
    for k in jev.galois_keys.keys.values():
        k.data = jax.device_put(k.data, ksh)
    v = np.random.default_rng(2).uniform(-0.8, 0.8, (4, jctx.cfg.slots))
    jct = jencryptor.encrypt(jencryptor.encode(v, n_q=jctx.n_q0))
    want = jbt(JCiphertext(jax.device_put(
        jct.data, jsh.ct_sharding(jmesh, batched=True, limb=True)),
        jct.scale, True)).data

    ctx = Context(CKKSConfig(**BOOT_CFG), device="cpu")
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=9, device="cpu")
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device="cpu")
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), device="cpu")
    bt = Bootstrapper(ev, enc, lt_group=3, evalmod_degree=59)
    ev.galois_keys = kg.gen_galois_keys(steps=bt.galois_steps(),
                                        conjugate=True)
    ct = encryptor.encrypt(encryptor.encode(v, n_q=ctx.n_q0))
    assert _eq(ct.data, jct.data)
    mesh = _cpu_mesh(4, 2)
    out = ShardedBootstrapper(bt, mesh)(shard_ciphertext(ct, mesh,
                                                         limb=True))
    got = gather(out, "cpu")
    assert got.data.dtype == torch.int32 and _eq(got.data, want)
    assert torch.equal(got.data, bt(ct).data)


@pytest.mark.slow
def test_make_refresh_on_mesh_equals_unsharded():
    """build_bootstrap's Bootstrapper as ShardedBootstrapper.make_refresh,
    its batch of 4 split over a (2, 1) and a (4, 1) mesh, and with its
    limbs split too over a (2, 2) mesh: the unsharded refresh's residues
    (logN 9)."""
    cfg = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                     n_data_levels=13, dnum=7, special_bits=29.5,
                     hamming_weight=64)
    want = build_bootstrap(cfg, 4, seed=101, device="cpu")
    out = want.fn(want.x_data)
    x = Ciphertext(want.x_data, want.ctx.scale, True)
    for n, la in ((2, 1), (4, 1), (4, 2)):
        refresh = ShardedBootstrapper(want.bootstrapper,
                                      _cpu_mesh(n, la)).make_refresh()
        got = refresh(x, want.n_out)
        assert got.scale == out.scale and torch.equal(got.data, out.data)
