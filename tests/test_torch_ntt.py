"""moai_tpu_torch NTT against moai_tpu: the plain transforms are bit-equal
to the JAX 4-step transforms (logN 9-11, batched, limb-sliced) and to the
Pallas kernels in interpret mode (logN 9).  The CUDA kernels are held
against the plain transforms on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moai_tpu.ntt import NttTables as JNttTables, ntt as jntt, intt as jintt
from moai_tpu.pallas_ntt import PallasNttTables, ntt_pallas, intt_pallas
from moai_tpu_torch import ntt_cuda
from moai_tpu_torch.ntt import NttTables, ntt, intt
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
    x = torch.zeros((2, 1 << 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="two-pass"):
        ntt_cuda.ntt_cuda(x, None)
    with pytest.raises(ValueError, match="two-pass"):
        ntt_cuda.intt_cuda(x, None)
    # a CPU tensor never reaches a kernel, and the wrapper takes no fallback
    with pytest.raises(ValueError, match="CUDA tensor"):
        ntt_cuda.ntt_cuda(torch.zeros((2, 1 << 9), dtype=torch.int64), None)

