"""The encrypted attention head over a ("col", "limb") mesh of CPU devices
(moai_tpu_torch.parallel.sharding), the port of
``__graft_entry__.dryrun_multichip``, at its shapes (logN 9, L 26, 32
inputs of 8 tokens, d_model 8, head_dim 8, exp_r 2, inv_iters 2, 3
inputs, seed 11, the input at ctx.scale).

Each sharded piece gathers to the residues of its unsharded counterpart
in the port, on meshes (2, 1), (1, 2) and (2, 2) (and (4, 1), whose
diagonal split cuts two BSGS groups): the plaintext ops of
``ShardedEvaluator``, ``cpmm_sharded`` with its mask and bias,
``softmax_diag_sharded`` with the identity refresh and with one that
counts its calls and changes the sum, and ``ccmm_diag_to_col_sharded``;
then the whole ``build_sharded_head`` against ``build_head``, on those
meshes and on dryrun_multichip's (4, 2).  The tier-1 tests run no JAX.
The slow test holds the sharded head bit for bit against dryrun_multichip's
own program: ``_build_head``'s head jitted over the 8 virtual CPU devices
(tests/conftest.py) with its shardings."""

import numpy as np
import pytest
import torch

from moai_tpu_torch.ciphertext import Ciphertext, Plaintext
from moai_tpu_torch.entry import EPS, MAX_VAL, build_head, build_sharded_head
from moai_tpu_torch.ops.matmul import ccmm_col_to_diag, ccmm_diag_to_col
from moai_tpu_torch.ops.nonlinear import softmax_diag
from moai_tpu_torch.parallel.sharding import (
    ShardedEvaluator, ccmm_col_to_diag_sharded, ccmm_diag_to_col_sharded,
    copied, cpmm_sharded, gather, make_mesh, moved, reset_moved,
    shard_ciphertext, softmax_diag_sharded)

torch.set_num_threads(1)
# __graft_entry__.dryrun_multichip's _build_head arguments
DIMS = dict(logN=9, n_data_levels=12, num_x=32, num_row=8, d_model=8,
            head_dim=8, exp_r=2, inv_iters=2, input_count=3)
MESHES = [(2, 1), (1, 2), (2, 2)]


def _mesh(c, l):
    return make_mesh(c * l, limb_axis=l, devices=["cpu"] * (c * l))


def _same(got, want):
    """A gathered ShardedCiphertext equals an unsharded Ciphertext."""
    got = gather(got, "cpu")
    return got.scale == want.scale and got.data.dtype == torch.int32 and \
        torch.equal(got.data, want.data)


@pytest.fixture(scope="module")
def head():
    """build_head at DIMS and its unsharded values, step by step."""
    h = build_head(**DIMS, device="cpu", nominal_input_scale=True)
    ev = h.ev
    q_mm, k_mm, v_mm = h.mms
    x = Ciphertext(h.x_data, h.x_scale, True)
    val = {"x": x, "q": q_mm(x), "k": k_mm(x),
           "v": v_mm(ev.mod_drop_to(x, h.n_v + 2))}
    val["qkt"] = ccmm_col_to_diag(ev, val["q"], val["k"], h.num_x,
                                  h.num_row)
    val["sm"] = softmax_diag(ev, h.encoder, val["qkt"], h.masks, MAX_VAL,
                             lambda ct: ct, inv_iters=h.inv_iters, eps=EPS,
                             out_n_q=h.n_v, exp_r=h.exp_r)
    val["out"] = ccmm_diag_to_col(ev, val["sm"], val["v"], h.num_x,
                                  h.num_row)
    assert torch.equal(val["out"].data, h.fn(h.x_data).data)
    return h, val


def test_plaintext_ops(head):
    """negate, add_plain and multiply_plain, with a plaintext batched like
    the ciphertext (cut by its cols) and an unbatched one, at the full
    level and at 8 limbs (the second limb shard empty): each gathers to
    the evaluator's residues."""
    h, val = head
    ev, ctx = h.ev, h.ctx
    rng = np.random.default_rng(5)
    for n_q in (ctx.L, 8):
        x = ev.mod_drop_to(val["x"], n_q)
        qs = np.asarray(ctx.q_primes[:n_q], np.int64)[:, None]
        batched, single = (Plaintext(torch.from_numpy(
            (rng.integers(0, 1 << 62, shape + (n_q, ctx.cfg.N)) % qs)
            .astype(np.int32)), x.scale) for shape in ((8,), ()))
        for c, l in MESHES:
            mesh = _mesh(c, l)
            sev = ShardedEvaluator(ev, mesh)
            sx = shard_ciphertext(x, mesh, limb=l > 1)
            assert _same(sev.negate(sx), ev.negate(x))
            for pt in (batched, single):
                assert _same(sev.add_plain(sx, pt), ev.add_plain(x, pt))
                assert _same(sev.multiply_plain(sx, pt),
                             ev.multiply_plain(x, pt))


def test_cpmm_sharded(head):
    """Q (mask and bias) and V (at V's level) with their output columns
    split over col: the unsharded CPMMs' residues.  The partials meet in a
    reduce-scatter before the mask and the rescales."""
    h, val = head
    q_mm, _, v_mm = h.mms
    for c, l in MESHES + [(4, 1)]:
        mesh = _mesh(c, l)
        sev = ShardedEvaluator(h.ev, mesh)
        sx = shard_ciphertext(val["x"], mesh, limb=l > 1)
        reset_moved()
        q = cpmm_sharded(sev, q_mm, sx)
        assert q.cols == (None if c == 1 else
                          [(i * 8 // c, (i + 1) * 8 // c) for i in range(c)])
        assert _same(q, val["q"])
        # each row sends the others their columns of its partial [I, 2, L,
        # N]: (c - 1) partials in all
        assert moved["reduce"] == (c - 1) * q_mm.out_dim * 2 * h.ctx.L * \
            h.ctx.cfg.N * 4
        v = cpmm_sharded(sev, v_mm, sev.mod_drop_to(sx, h.n_v + 2))
        assert v.cols == q.cols and _same(v, val["v"])


def test_softmax_sharded(head):
    """The softmax over QK^T as ccmm_col_to_diag_sharded returns it
    (replicated over col): with the identity refresh, and with a refresh
    that counts its calls and adds 1/16 to the sum.  The sum reaches the
    refresh once, on one row, and the result is the unsharded softmax's
    with the same refresh."""
    h, val = head
    ev = h.ev
    kw = dict(inv_iters=h.inv_iters, eps=EPS, out_n_q=h.n_v, exp_r=h.exp_r)
    calls = []

    def counting(evaluator):
        def refresh(s):
            calls.append(s)
            return evaluator.add_const(s, 1 / 16)
        return refresh
    want = softmax_diag(ev, h.encoder, val["qkt"], h.masks, MAX_VAL,
                        counting(ev), **kw)
    assert len(calls) == 1 and not torch.equal(want.data, val["sm"].data)
    for c, l in MESHES:
        mesh = _mesh(c, l)
        sev = ShardedEvaluator(ev, mesh)
        qkt = ccmm_col_to_diag_sharded(
            sev, *[shard_ciphertext(val[k], mesh, limb=l > 1)
                   for k in ("q", "k")], h.num_x, h.num_row)
        assert qkt.cols is None and _same(qkt, val["qkt"])
        sm = softmax_diag_sharded(sev, h.encoder, qkt, h.masks, MAX_VAL,
                                  lambda ct: ct, **kw)
        assert sm.cols == (None if c == 1 else [(0, 4), (4, 8)])
        assert _same(sm, val["sm"])
        calls.clear()
        assert _same(softmax_diag_sharded(sev, h.encoder, qkt, h.masks,
                                          MAX_VAL, counting(sev), **kw), want)
        assert len(calls) == 1 and {p[0] for p in calls[0].shards} == {0}


def test_ccmm_diag_to_col_sharded(head):
    """softmax x V with the diagonals split over col and V split too (so
    all-gathered): BSGS groups of 3 over 8 diagonals, which (2, *) cut at
    diagonal 4 and (4, 1) at 2 and 4; the output's columns over col."""
    h, val = head
    for c, l in MESHES + [(4, 1)]:
        mesh = _mesh(c, l)
        sev = ShardedEvaluator(h.ev, mesh)
        out = ccmm_diag_to_col_sharded(
            sev, *[shard_ciphertext(val[k], mesh, limb=l > 1)
                   for k in ("sm", "v")], h.num_x, h.num_row)
        assert out.cols == (None if c == 1 else
                            [(i * 8 // c, (i + 1) * 8 // c) for i in range(c)])
        assert _same(out, val["out"])


@pytest.mark.parametrize("c,l", MESHES + [(4, 2)])
def test_build_sharded_head(head, c, l):
    """build_sharded_head on the mesh ((4, 2): dryrun_multichip's, the
    input at P("col", None, "limb", None); (2, 1) with its limbs
    unsplit): the same keys and input as build_head, its output
    bit-identical, its columns over col; every kind of transfer but the
    gather was made, and only a limb split's placement copied the input
    (each of its shards a strided slice)."""
    h, val = head
    mode = "limb" if l > 1 else "col"
    S = build_sharded_head(**DIMS, mesh=_mesh(c, l), mode=mode, device="cpu",
                           nominal_input_scale=True)
    assert torch.equal(S.head.x_data, h.x_data)
    reset_moved()
    out = S.fn(S.head.x_data)
    assert {k for k, v in moved.items() if v} == \
        {"scatter", "broadcast", "all_gather"} | ({"reduce"} if c > 1 else
                                                  set())
    assert copied == dict.fromkeys(moved, 0) | {
        "scatter": h.x_data.numel() * 4 if l > 1 else 0}
    assert out.cols == (None if c == 1 else
                        [(i * 8 // c, (i + 1) * 8 // c) for i in range(c)])
    assert _same(out, val["out"])
    assert S.plain is S.head.fn


@pytest.mark.slow
def test_head_bit_identical_to_jax_dryrun():
    """dryrun_multichip's program, jitted over the 8 virtual CPU devices as
    a (4, 2) mesh with the input and output at P("col", None, "limb",
    None), and the port's sharded head on a (4, 2) mesh of 8 x "cpu":
    the same input residues, the same output residues."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    import __graft_entry__ as ge
    from moai_tpu.parallel.sharding import make_mesh as jax_mesh
    head_fn, x_data, _ = ge._build_head(**DIMS)
    sh = NamedSharding(jax_mesh(8, limb_axis=2), P("col", None, "limb",
                                                   None))
    x = jax.device_put(x_data, sh)
    want = jax.jit(head_fn, in_shardings=(sh,), out_shardings=sh).lower(
        x).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})(x)
    S = build_sharded_head(**DIMS, mesh=_mesh(4, 2), mode="limb",
                           device="cpu", nominal_input_scale=True)
    assert np.array_equal(S.head.x_data.numpy().astype(np.int64),
                          np.asarray(x_data).astype(np.int64))
    got = gather(S.fn(S.head.x_data), "cpu")
    assert np.array_equal(got.data.numpy().astype(np.int64),
                          np.asarray(want).astype(np.int64))
