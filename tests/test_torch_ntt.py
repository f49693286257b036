"""moai_tpu_torch NTT against moai_tpu: the plain transforms are bit-equal
to the JAX 4-step transforms (logN 9-11 and 16, batched, limb-sliced) and
to the Pallas kernels in interpret mode (logN 9).  The CUDA kernels' tables
are checked against NttTables here, and a numpy model of the kernels'
two passes (their tiling, register passes, tables and index maps) against
the plain transforms; the kernels themselves are held against the plain
transforms on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moai_tpu.ntt import NttTables as JNttTables, ntt as jntt, intt as jintt
from moai_tpu.pallas_ntt import PallasNttTables, ntt_pallas, intt_pallas
from moai_tpu_torch import ntt_cuda
from moai_tpu_torch.ntt import NttTables, ntt, intt, _bitrev_perm
from moai_tpu_torch.params import Context, test_config as _test_config
from moai_tpu_torch.primes import ntt_primes_near

torch.set_num_threads(1)
RNG = np.random.default_rng(12)


def _tables(logN):
    qs = ntt_primes_near(26.0, 2 << logN, 3) + \
        ntt_primes_near(29.5, 2 << logN, 2, direction="up")
    return JNttTables(logN, qs), NttTables(logN, qs), qs


def _rand(qs, lead, N):
    x = np.empty(lead + (len(qs), N), np.uint32)
    for i, q in enumerate(qs):
        x[..., i, :] = RNG.integers(0, q, size=lead + (N,))
    return x


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("logN", [9, 10, 11])
def test_plain_matches_jax(logN):
    jt, pt, qs = _tables(logN)
    jtb, ptb = jt.device(), pt.to("cpu")
    x = _rand(qs, (2, 3), 1 << logN)
    fwd = ntt(_t(x), ptb)
    assert torch.equal(fwd, _t(jax.jit(lambda a: jntt(a, jtb))(x)))
    back = intt(fwd, ptb)
    want = jax.jit(lambda a: jintt(a, jtb))(fwd.numpy().astype(np.uint32))
    assert torch.equal(back, _t(want))
    assert torch.equal(back, _t(x))


@pytest.mark.parametrize("logN,sl", [(10, (1, 4)), (11, (3, 5))])
def test_limb_slice_matches_jax(logN, sl):
    jt, pt, qs = _tables(logN)
    x = _rand(qs, (2,), 1 << logN)[..., sl[0]:sl[1], :]
    got = ntt(_t(x), pt.to("cpu"), limb_slice=sl)
    jtb = jt.device()
    assert torch.equal(got, _t(jax.jit(lambda a: jntt(a, jtb,
                                                      limb_slice=sl))(x)))
    assert torch.equal(intt(got, pt.to("cpu"), limb_slice=sl), _t(x))


def test_plain_matches_pallas_interpret():
    jt, pt, qs = _tables(9)
    tbp = PallasNttTables(jt).device()
    x = _rand(qs, (3,), 1 << 9)
    fwd = ntt_pallas(jnp.asarray(x), tbp, interpret=True)
    assert torch.equal(ntt(_t(x), pt.to("cpu")), _t(fwd))
    assert torch.equal(intt(_t(fwd), pt.to("cpu")),
                       _t(intt_pallas(fwd, tbp, interpret=True)))
    sl = (1, 3)
    got = ntt_pallas(jnp.asarray(x[0, 1:3]), tbp, limb_slice=sl,
                     interpret=True)
    assert torch.equal(ntt(_t(x[0, 1:3]), pt.to("cpu"), limb_slice=sl),
                       _t(got))


def test_cuda_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Context(_test_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Context(_test_config(), device="cuda")


def test_kernel_wrapper_refuses():
    for log_n in (8, 17):
        x = torch.zeros((2, 1 << log_n), dtype=torch.int64)
        with pytest.raises(ValueError, match="2\\^9 .. 2\\^16"):
            ntt_cuda.ntt_cuda(x, None)
        with pytest.raises(ValueError, match="2\\^9 .. 2\\^16"):
            ntt_cuda.intt_cuda(x, None)
    # a CPU tensor never reaches a kernel, and the wrapper takes no fallback
    for log_n in (9, 16):
        x = torch.zeros((2, 1 << log_n), dtype=torch.int64)
        with pytest.raises(ValueError, match="CUDA tensor"):
            ntt_cuda.ntt_cuda(x, None)
        with pytest.raises(ValueError, match="CUDA tensor"):
            ntt_cuda.intt_cuda(x, None)


def test_plain_matches_jax_logn16():
    """The n1 = n2 = 256 split that the kernels follow at N = 2^16."""
    qs = ntt_primes_near(26.0, 2 << 16, 2) + \
        ntt_primes_near(29.5, 2 << 16, 1, direction="up")
    jt, pt = JNttTables(16, qs), NttTables(16, qs)
    jtb, ptb = jt.device(), pt.to("cpu")
    x = _rand(qs, (1,), 1 << 16)
    fwd = ntt(_t(x), ptb)
    assert torch.equal(fwd, _t(jax.jit(lambda a: jntt(a, jtb))(x)))
    back = intt(fwd, ptb)
    want = jax.jit(lambda a: jintt(a, jtb))(fwd.numpy().astype(np.uint32))
    assert torch.equal(back, _t(want))
    assert torch.equal(back, _t(x))


# ---------------------------------------------------------------------------
# the CUDA kernels' tables, and a numpy model of csrc/ntt.cu
# ---------------------------------------------------------------------------

def _u64(t: torch.Tensor) -> np.ndarray:
    """A CudaNttTables tensor (uint32 bit patterns in int32) as uint64."""
    return t.numpy().view(np.uint32).astype(np.uint64)


@pytest.mark.parametrize("logN", [15, 16])
def test_cuda_tables_from_ntt_tables(logN):
    qs = ntt_primes_near(26.0, 2 << logN, 1) + \
        ntt_primes_near(29.5, 2 << logN, 1, direction="up")
    nt = NttTables(logN, qs)
    ct = ntt_cuda.CudaNttTables(nt, "cpu")
    N, n1, n2 = nt.N, nt.n1, nt.n2
    assert ct.fwd_cols.shape == ct.inv_cols.shape == (2, n1, 2)
    assert ct.fwd_rows.shape == ct.inv_rows.shape == (2, n2, 2)
    assert ct.fwd_mid.shape == ct.inv_mid.shape == (2, n1, n2, 2)
    assert np.array_equal(_u64(ct.q), np.array(qs, np.uint64))
    e_cols = n2 * _bitrev_perm(n1)
    for l, q in enumerate(qs):
        q64 = np.uint64(q)
        psi = nt.psi_pl[l].astype(np.uint64)          # psi^j, j < N
        psii_n = nt.psiinv_n_pl[l].astype(np.uint64)  # psi^-j / N
        want = {
            "fwd_cols": psi[e_cols],
            "inv_cols": psii_n[e_cols] * np.uint64(N % q) % q64,
            "fwd_mid": psi[None, :n2] * nt.w_mid_pl[l] % q64,
            "inv_mid": psii_n[None, :n2] * nt.w_mid_inv_pl[l] % q64,
        }
        w_n2 = int(nt.stage_tw[n2][0][l, 0, 1])       # the n2-th root
        rows = [1]
        m = 1
        while m < n2:
            rows += [pow(w_n2, (n2 // (2 * m)) * int(b), q)
                     for b in _bitrev_perm(m)]
            m *= 2
        want["fwd_rows"] = np.array(rows, np.uint64)
        for name, w in want.items():
            got = _u64(getattr(ct, name))[l]
            assert np.array_equal(got[..., 0], w), name
            assert np.array_equal(got[..., 1], (w << np.uint64(32)) // q64)
        fr, ir = _u64(ct.fwd_rows)[l, :, 0], _u64(ct.inv_rows)[l, :, 0]
        assert np.all(fr * ir % q64 == 1)


M32 = np.uint64(0xFFFFFFFF)


def _shoup_lazy(x, w, q):
    """shoup_lazy of csrc/ntt.cu in uint64 (w[..., 0] twiddle, [..., 1]
    its companion; products wrap mod 2^32): x * w mod q in [0, 2q)."""
    return (x * w[..., 0] - ((x * w[..., 1]) >> np.uint64(32)) * q) & M32


def _reduce(x, q):
    """min(x, x - q) in uint32: x mod q for x < 2q."""
    return np.minimum(x, (x - q) & M32)


def _shoup(x, w, q):
    return _reduce(_shoup_lazy(x, w, q), q)


def _radix_pass(a, log_n, log_p, s0, R, tw, q, inverse):
    """radix_pass<R, inverse> of csrc/ntt.cu on every block at once: a is
    [blocks, n * (2^log_p + 1)] (the shared tile), tw [blocks, n, 2]."""
    K, stride, b_lo = 1 << R, (1 << log_p) + 1, log_n - s0 - R
    g = np.arange(1 << (log_n - R + log_p))
    c, grp = g & ((1 << log_p) - 1), g >> log_p
    i0 = grp >> b_lo
    base = ((i0 << (b_lo + R)) | (grp & ((1 << b_lo) - 1))) * stride + c
    idx = [base + k * (stride << b_lo) for k in range(K)]
    v = [a[:, i] for i in idx]
    for l in (range(R - 1, -1, -1) if inverse else range(R)):
        half = K >> (l + 1)
        for k in range(K):
            if k & half:
                continue
            w = tw[:, (1 << (s0 + l)) + (i0 << l) + (k >> (R - l))]
            u, t = v[k], v[k + half]
            if inverse:                   # [0, 2q) -> [0, 2q)
                v[k] = _reduce((u + t) & M32, 2 * q)
                v[k + half] = _shoup_lazy((u - t + 2 * q) & M32, w, q)
            else:                         # [0, 4q) -> [0, 4q)
                u, t = _reduce(u, 2 * q), _shoup_lazy(t, w, q)
                v[k], v[k + half] = (u + t) & M32, (u - t + 2 * q) & M32
    if inverse and s0 == 0:               # the last pass: canonical
        v = [_reduce(x, q) for x in v]
    if not inverse and s0 + R == log_n:
        v = [_reduce(_reduce(x, 2 * q), q) for x in v]
    for k, i in enumerate(idx):
        a[:, i] = v[k]


RADIX_LOG = 4     # kRadixLog of csrc/ntt.cu: stages per register pass


def _transform(a, log_n, log_p, tw, q, inverse):
    """ct_transform / gs_transform: RADIX_LOG stages per pass."""
    passes = [(s0, min(RADIX_LOG, log_n - s0))
              for s0 in range(0, log_n, RADIX_LOG)]
    for s0, r in (passes[::-1] if inverse else passes):
        _radix_pass(a, log_n, log_p, s0, r, tw, q, inverse)


def _model(x, ct, lo, inverse):
    """The kernels' two passes on x [..., limbs, N] (uint64 numpy), with
    the launch geometry of plan() and the two templates' index maps."""
    limbs, N = x.shape[-2:]
    log_n = N.bit_length() - 1
    l1, l2 = log_n // 2, log_n - log_n // 2
    n1, n2 = 1 << l1, 1 << l2
    src = x.reshape(-1).copy()
    rows = src.size // N
    q_all = _u64(ct.q)

    def blocks(log_tiled):
        """plan() and block_of(): limb-major blocks of 2^lp transforms."""
        lp = min(5, log_tiled)
        b = np.arange(rows << (log_tiled - lp))
        rb, tile = b >> (log_tiled - lp), b & ((1 << (log_tiled - lp)) - 1)
        limb, bat = rb // (rows // limbs), rb % (rows // limbs)
        row = bat * limbs + limb
        limb = limb + lo
        return lp, (1 << lp) + 1, row, tile << lp, limb, q_all[limb][:, None]

    def cols(src, tw, mid):
        """ntt_cols<false> (mid given) or ntt_cols<true> (mid None)."""
        lp, stride, row, j2_0, limb, q = blocks(l2)
        e = np.arange(n1 << lp)
        i, c = e >> lp, e & ((1 << lp) - 1)
        glob = ((row << log_n) + j2_0)[:, None] + i * n2 + c
        nat, spec = i * stride + c, _bitrev_perm(n1)[i] * stride + c
        a = np.zeros((row.size, n1 * stride), np.uint64)
        a[:, spec if mid is None else nat] = src[glob]
        _transform(a, l1, lp, _u64(tw)[limb], q, mid is None)
        out = np.zeros_like(src)
        if mid is None:
            out[glob] = a[:, nat]
        else:
            m = _u64(mid).reshape(-1, N, 2)[limb[:, None],
                                            i * n2 + c + j2_0[:, None]]
            out[glob] = _shoup(a[:, spec], m, q)
        return out

    def rows_(src, tw, mid):
        """ntt_rows<false> (mid None) or ntt_rows<true> (mid given)."""
        lp, stride, row, k1_0, limb, q = blocks(l1)
        e = np.arange(n2 << lp)
        k2, r = e >> lp, e & ((1 << lp) - 1)
        a = np.zeros((row.size, n2 * stride), np.uint64)
        brv = _bitrev_perm(n2)
        f = np.arange(1 << (lp + l2))                 # e of the other loops
        fr, fj = f >> l2, f & (n2 - 1)
        soff = ((row << log_n) + (k1_0 << l2))[:, None]
        xoff = ((row << log_n) + k1_0)[:, None]
        if mid is None:
            a[:, fj * stride + fr] = src[soff + f]
        else:
            a[:, brv[k2] * stride + r] = src[xoff + k2 * n1 + r]
        _transform(a, l2, lp, _u64(tw)[limb], q, mid is not None)
        out = np.zeros_like(src)
        if mid is None:
            out[xoff + k2 * n1 + r] = a[:, brv[k2] * stride + r]
        else:
            m = _u64(mid).reshape(-1, N, 2)[limb[:, None],
                                            (k1_0 << l2)[:, None] + f]
            out[soff + f] = _shoup(a[:, fj * stride + fr], m, q)
        return out

    if inverse:
        y = cols(rows_(src, ct.inv_rows, ct.inv_mid), ct.inv_cols, None)
    else:
        y = rows_(cols(src, ct.fwd_cols, ct.fwd_mid), ct.fwd_rows, None)
    return y.reshape(x.shape)


@pytest.mark.parametrize("logN,sl", [(9, None), (10, None), (11, None),
                                     (11, (1, 4))])
def test_kernel_model_matches_plain(logN, sl):
    _, pt, qs = _tables(logN)
    ct = ntt_cuda.CudaNttTables(pt, "cpu")
    lo, hi = sl or (0, len(qs))
    x = _rand(qs, (2,), 1 << logN)[..., lo:hi, :].astype(np.uint64)
    fwd = _model(x, ct, lo, inverse=False)
    want = ntt(_t(x), pt.to("cpu"), limb_slice=sl)
    assert torch.equal(_t(fwd), want)
    back = _model(fwd, ct, lo, inverse=True)
    assert torch.equal(_t(back), intt(want, pt.to("cpu"), limb_slice=sl))
    assert np.array_equal(back, x)
