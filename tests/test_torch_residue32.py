"""The port's at-rest residue format: int32 on every device.

Every residue the port holds is an int32 tensor with the canonical
Montgomery value in [0, q), as the JAX package holds it in uint32.  Here,
with no JAX: each plain op of ``mod_arith`` on int32 against a Python
big-int reckoning at the edges (0, 1, q - 1 and, where the op's domain
takes them, inputs in [q, 2^31)); the int64 sums of the plain loops, of
``ops``' column sums and of ``mod_matmul``'s accumulator with every input
at q - 1 and the most terms their callers pass; a small head, a small
layer and the logN-9 bootstrap, run with every limb op and transform
checking that each tensor it is handed is int32 (as the card's kernels
refuse anything else) and returning int32 ciphertexts, plaintexts and
keys; and ``serial``'s checked reinterpretation of uint32 files as int32
tensors, both ways."""

import inspect
import io
import zipfile

import numpy as np
import pytest
import torch

from moai_tpu_torch import convert, serial
from moai_tpu_torch import mod_arith as ma
from moai_tpu_torch import ntt as ntt_mod
from moai_tpu_torch.ciphertext import Ciphertext
from moai_tpu_torch.entry import build_bootstrap, build_head, build_layer
from moai_tpu_torch.keys import KSwitchKey
from moai_tpu_torch.modmat import host_bucket_consts, host_weight_digits, \
    mod_matmul
from moai_tpu_torch.models.bert import BertDims, DepthPlan
from moai_tpu_torch.ops.matmul import _dyadic_sum
from moai_tpu_torch.ops.nonlinear import _sum_leading
from moai_tpu_torch.params import CKKSConfig, Context, head_config

torch.set_num_threads(1)

R = 1 << 32
# the largest odd prime below 2^30 of the chains' kind, a 26-bit data
# prime, and a small NTT prime
PRIMES = (Context(head_config(11, 3), device="cpu").q_primes[0],
          Context(head_config(11, 3), device="cpu").q_primes[3], 12289)
CKKS_BOOT = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                       n_data_levels=13, dnum=7, special_bits=29.5,
                       hamming_weight=64)


def _i32(vals) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int32)


def _edges(q: int, full: bool) -> list[int]:
    """0, 1, q - 1 and random residues; with ``full`` also q, q + 1,
    2q - 1, 2^30 - 1 and 2^31 - 1."""
    rng = np.random.default_rng(q)
    out = [0, 1, q - 1, q - 2] + [int(v) for v in rng.integers(0, q, 12)]
    if full:
        out += [q, q + 1, 2 * q - 1, (1 << 30) - 1, (1 << 31) - 1]
    return out


def test_plain_ops_equal_big_int_reckoning():
    """add/sub/neg/mont_mul/to_mont/from_mont/sub_mont_mul on int32
    operands return int32 canonical residues equal to Python's exact
    reckoning: the elementwise ops on every pair of values in [0, 2^31)
    of the edge set (the kernel's domain), the loops on canonical
    residues."""
    for q in PRIMES:
        c = ma.mont_constants(q)
        rinv, r2 = c["rinv"], c["r2"]
        vals = _edges(q, full=True)
        a = _i32([x for x in vals for _ in vals])
        b = _i32([y for _ in vals for y in vals])
        A, B = a.tolist(), b.tolist()
        want = {
            "add": [(x + y) % q for x, y in zip(A, B)],
            "sub": [(x - y) % q for x, y in zip(A, B)],
            "neg": [(-x) % q for x in A],
            "mul": [x * y * rinv % q for x, y in zip(A, B)],
            "to_mont": [x * R % q for x in A],
            "from_mont": [x * rinv % q for x in A],
            "sub_mul": [(x - y) * y * rinv % q for x, y in zip(A, B)],
        }
        got = {
            "add": ma.add_mod(a, b, q), "sub": ma.sub_mod(a, b, q),
            "neg": ma.neg_mod(a, q), "mul": ma.mont_mul(a, b, q, rinv),
            "to_mont": ma.to_mont(a, q, rinv, r2),
            "from_mont": ma.from_mont(a, q, rinv),
            "sub_mul": ma.sub_mont_mul(a, b, b, q, rinv),
        }
        for op, w in want.items():
            assert got[op].dtype == torch.int32, op
            assert got[op].tolist() == w, (op, q)
        # a per-limb int32 modulus column broadcast over rows
        qcol = _i32([[p] for p in PRIMES])
        rcol = _i32([[ma.mont_constants(p)["rinv"]] for p in PRIMES])
        x = _i32([[v % p for v in _edges(p, full=False)] for p in PRIMES])
        got = ma.mont_mul(x, x, qcol, rcol)
        assert got.dtype == torch.int32
        assert got.tolist() == [[v * v * ma.mont_constants(p)["rinv"] % p
                                 for v in row] for p, row in
                                zip(PRIMES, x.tolist())]


def test_plain_loops_at_q_minus_1():
    """base_conv (32 inputs a digit), ks_mac (16 digits) and diag_mac (32
    diagonals), every input at q - 1: int32 canonical results equal to the
    reckoning, their int64 sums of many products intact."""
    qs = list(PRIMES)
    n = 8
    qcol = _i32([[q] for q in qs])
    rinv = [ma.mont_constants(q)["rinv"] for q in qs]
    rcol = _i32([[r] for r in rinv])
    full = _i32([[q - 1] * n for q in qs])                  # [3, n]
    # diag_mac: sum_j (q-1)^2 R^-1, 32 terms, two polynomials
    cts = [full.expand(2, 3, n).contiguous() for _ in range(32)]
    got = ma.diag_mac(cts, full.expand(32, 3, n).contiguous(), qcol, rcol)
    assert got.dtype == torch.int32
    for i, q in enumerate(qs):
        assert (got[:, i] == 32 * (q - 1) ** 2 * rinv[i] % q).all()
    # ks_mac: 16 digits, targets = the three primes (no special limbs)
    y = full.expand(1, 16, 3, n).contiguous()
    key = full.expand(16, 2, 3, n).contiguous()
    acc0, acc1 = ma.ks_mac(y, key, 3, qcol, rcol)
    for acc in (acc0, acc1):
        assert acc.dtype == torch.int32
        for i, q in enumerate(qs):
            assert (acc[0, i] == 16 * (q - 1) ** 2 * rinv[i] % q).all()
    # base_conv: one digit of 32 inputs (each the first prime's q - 1)
    # to the three primes, hat at q_t - 1
    q0 = qs[0]
    x = torch.full((1, 32, n), q0 - 1, dtype=torch.int32)
    src = torch.full((32,), q0, dtype=torch.int32)
    src_r = torch.full((32,), rinv[0], dtype=torch.int32)
    hat = _i32([[q - 1 for q in qs]] * 32)[None]          # [1, 32, 3]
    got = ma.base_conv(x, src, src_r, None, hat, qcol, rcol)
    assert got.dtype == torch.int32
    for i, q in enumerate(qs):
        assert (got[0, 0, i] == 32 * (q0 - 1) * (q - 1) * rinv[i] % q).all()


def test_column_sums_and_mod_matmul_at_q_minus_1():
    """``_sum_leading`` over 768 columns (BERT-base's d_model, the most
    LayerNorm sums), ``_dyadic_sum`` over 768 (ccmm_col_to_diag's column
    axis, whole) and ``mod_matmul`` over J = 3072 (d_inter, W_F's
    contraction), every input at q - 1: int32 results equal to the
    reckoning."""
    qs = list(PRIMES)
    n = 16
    qcol = _i32([[q] for q in qs])
    rinv = [ma.mont_constants(q)["rinv"] for q in qs]
    rcol = _i32([[r] for r in rinv])
    full = _i32([[q - 1] * n for q in qs])                  # [3, n]
    got = _sum_leading(full.expand(768, 2, 3, n), qcol)
    assert got.dtype == torch.int32
    for i, q in enumerate(qs):
        assert (got[:, i] == 768 * (q - 1) % q).all()
    x = full.expand(1, 768, 3, n)
    got = _dyadic_sum(x, x, x, x, 1, qcol, rcol)             # [1, 3, 3, n]
    assert got.dtype == torch.int32 and got.shape == (1, 3, 3, n)
    for i, q in enumerate(qs):
        one = 768 * (q - 1) ** 2 * rinv[i] % q
        assert (got[0, 0, i] == one).all() and (got[0, 2, i] == one).all()
        assert (got[0, 1, i] == 2 * one % q).all()
    J, I = 3072, 2
    xm = full.expand(J, 1, 3, n).contiguous()
    w = np.stack([np.full((J, I), q - 1, np.int64) for q in qs])
    got = mod_matmul(xm, torch.from_numpy(host_weight_digits(w)),
                     torch.from_numpy(host_bucket_consts(qs)),
                     _i32(qs), _i32(rinv))
    assert got.dtype == torch.int32 and got.shape == (I, 1, 3, n)
    for i, q in enumerate(qs):
        assert (got[:, :, i] == J * (q - 1) ** 2 % q).all()


@pytest.fixture
def int32_only(monkeypatch):
    """Every limb op of ``mod_arith`` and both plain transforms check, on
    each call, that each tensor handed to them is int32 (a Galois
    permutation, ``perm``, is an index); returns the calls by name."""
    calls = {}

    def checked(name, fn):
        sig = inspect.signature(fn)

        def call(*args, **kw):
            for arg, v in sig.bind(*args, **kw).arguments.items():
                for t in v if isinstance(v, (list, tuple)) else (v,):
                    if isinstance(t, torch.Tensor) and arg != "perm":
                        assert t.dtype == torch.int32, (name, arg, t.dtype)
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return call
    for name in ("add_mod", "sub_mod", "neg_mod", "mont_mul", "from_mont",
                 "sub_mont_mul", "base_conv", "ks_mac", "diag_mac"):
        monkeypatch.setattr(ma, name, checked(name, getattr(ma, name)))
    for name in ("ntt_plain", "intt_plain"):
        monkeypatch.setattr(ntt_mod, name, checked(name,
                                                   getattr(ntt_mod, name)))
    return calls


def _all_int32(*tensors):
    for t in tensors:
        assert t.dtype == torch.int32, t.dtype
        assert int(t.min()) >= 0 and int(t.max()) < 1 << 30


def test_head_and_layer_hold_int32(int32_only):
    """A small head and a small layer (the encoder's set-up: keys,
    weights, encryption) and their passes: every limb op and transform is
    handed int32 residues, and the inputs and outputs are int32."""
    h = build_head(logN=9, n_data_levels=12, num_x=32, num_row=8, d_model=8,
                   head_dim=8, exp_r=2, inv_iters=2, input_count=3,
                   device="cpu")
    out = h.fn(h.x_data)
    _all_int32(h.x_data, out.data, h.decryptor.sk.s_ntt)
    assert np.abs(h.decode(out) - h.oracle()).max() < 1.5e-8
    lay = build_layer(9, 10, BertDims(32, 8, 8, 2, 4, 16),
                      DepthPlan(2, 2, 1, 0, 8), 3, device="cpu")
    ev = lay.layer.ev
    _all_int32(lay.x_data, ev.relin_key.data,
               *[k.data for k in ev.galois_keys.keys.values()])
    out = lay.fn(lay.x_data)
    _all_int32(out.data)
    assert np.abs(lay.decode(out) - lay.oracle()).max() < 1e-6
    assert {"mont_mul", "base_conv", "ks_mac", "ntt_plain",
            "intt_plain"} <= set(int32_only)


def test_bootstrap_holds_int32(int32_only):
    """The logN-9 bootstrap (L 28): keys, the encrypted input, ModRaise's
    multiple k, the diagonals' residues and the refreshed output, all
    int32 through every limb op, and still within its error."""
    B = build_bootstrap(CKKS_BOOT, 2, seed=101, device="cpu")
    ev = B.bootstrapper.ev
    _all_int32(B.x_data, ev.relin_key.data, B.decryptor.sk.s_ntt,
               *[k.data for k in ev.galois_keys.keys.values()])
    out = B.fn(B.x_data)
    _all_int32(out.data)
    assert out.n_q == B.n_out
    assert np.abs(B.decode(out).real - B.values).max() < 1e-4
    assert int32_only.get("diag_mac", 0) > 0


def _npy_member(path, name) -> np.ndarray:
    with zipfile.ZipFile(path) as z:
        return np.lib.format.read_array(io.BytesIO(z.read(name + ".npy")))


def test_serial_int32_round_trip(tmp_path):
    """A ciphertext and a switching key written as uint32 members with the
    same 32-bit words and read back as int32, equal; a member written as
    the JAX writer writes it (deflated uint32) reads as int32; a stored
    word at or above 2^31, or a tensor outside [0, 2^31), raises; the
    converter from JAX arrays takes the same checked cast."""
    ctx = Context(head_config(9, 2), device="cpu")
    rng = np.random.default_rng(4)
    qs = np.array(ctx.q_primes, np.int64).reshape(-1, 1)
    data = torch.from_numpy(rng.integers(0, qs, (2, 2, ctx.L, ctx.cfg.N))
                            .astype(np.int32))
    ct = Ciphertext(data, 2.0 ** 40)
    path = str(tmp_path / "ct.zip")
    serial.save_ciphertext(path, ct, ctx.cfg)
    stored = _npy_member(path, "data")
    assert stored.dtype == np.uint32
    assert np.array_equal(stored.view(np.int32), data.numpy())
    back = serial.load_ciphertext(path, device="cpu")
    assert back.data.dtype == torch.int32 and torch.equal(back.data, data)
    key = KSwitchKey(data[:, :, :3].contiguous())
    serial.save_kswitch_key(str(tmp_path / "k.zip"), key)
    for dt in (torch.int32, torch.int64):
        k = serial.load_kswitch_key(str(tmp_path / "k.zip"), device="cpu",
                                    dtype=dt)
        assert k.data.dtype == dt and torch.equal(k.data, key.data)
    # the JAX writer's member: uint32, deflated
    jax_path = str(tmp_path / "jax.zip")
    with zipfile.ZipFile(path) as src, \
            zipfile.ZipFile(jax_path, "w", zipfile.ZIP_DEFLATED) as dst:
        dst.writestr("header.json", src.read("header.json"))
        buf = io.BytesIO()
        np.save(buf, stored)
        dst.writestr("data.npy", buf.getvalue())
    got = serial.load_ciphertext(jax_path, device="cpu")
    assert got.data.dtype == torch.int32 and torch.equal(got.data, data)
    # out of range, both ways
    bad = stored.copy()
    bad[0, 0, 0, 0] = 1 << 31
    with zipfile.ZipFile(jax_path, "w") as dst, zipfile.ZipFile(path) as src:
        dst.writestr("header.json", src.read("header.json"))
        buf = io.BytesIO()
        np.save(buf, bad)
        dst.writestr("data.npy", buf.getvalue())
    with pytest.raises(ValueError, match="2\\^31"):
        serial.load_ciphertext(jax_path, device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        serial.save_ciphertext(str(tmp_path / "x.zip"), Ciphertext(
            data.to(torch.int64) + (1 << 31), 1.0))
    assert convert.tensor(stored, device="cpu").dtype == torch.int32
    assert torch.equal(convert.tensor(stored, device="cpu"), data)
    with pytest.raises(ValueError, match="2\\^31"):
        convert.tensor(bad, device="cpu")
