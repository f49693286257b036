"""moai_tpu_torch.params.flagship_config and moai_tpu_torch.security against
moai_tpu: the logN-16 chain is the same config, field for field, and the
security estimates agree on the same inputs."""

import dataclasses

import pytest
import torch

from moai_tpu import params as jparams, security as jsec
from moai_tpu_torch import params as tparams, security as tsec

torch.set_num_threads(1)


def test_flagship_config_matches_jax():
    got, want = tparams.flagship_config(), jparams.flagship_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.N == want.N == 1 << 16
    assert tparams._approx_security_bits(got) == \
        jparams._approx_security_bits(want)


@pytest.mark.parametrize("n,log2_qp,h,quantum", [
    (1 << 15, 881.0, 64, False), (1 << 16, 1743.0, 192, False),
    (1 << 16, 2100.0, None, True), (1 << 14, 438.0, None, False)])
def test_security_bits_match(n, log2_qp, h, quantum):
    got = tsec.security_bits(n, log2_qp, hamming_weight=h, quantum=quantum)
    assert got == jsec.security_bits(n, log2_qp, hamming_weight=h,
                                     quantum=quantum)
    assert 0 < got < 1000


def test_context_security_bits_match():
    cfg = tparams.test_config()
    got = tsec.context_security_bits(tparams.Context(cfg, device="cpu"))
    assert got == jsec.context_security_bits(jparams.Context(cfg))
