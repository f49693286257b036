"""moai_tpu_torch's harness Recryptor at logN 9 on the head's chain (34
primes): a refresh gives residues bit-identical to
``moai_tpu.utils.recrypt.Recryptor``'s (run eagerly, as the JAX package's
own tests run it) on the same ciphertexts, keys and encryption randomness,
and decrypts to the values it was given."""

import dataclasses

import numpy as np
import pytest
import torch

from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.encrypt import Decryptor, Encryptor
from moai_tpu_torch.keys import KeyGenerator
from moai_tpu_torch.params import Context, head_config
from moai_tpu_torch.utils.recrypt import Recryptor

torch.set_num_threads(1)
SEED = 7
CFG = head_config(logN=9, n_data_levels=16)


def _pair():
    """The JAX Recryptor and the port's, their encryptors drawn from one
    seed in one order, so both draw the same encryption randomness."""
    from moai_tpu.params import CKKSConfig, make_context
    from moai_tpu.encoder import Encoder as JEncoder
    from moai_tpu.keys import KeyGenerator as JKeyGenerator
    from moai_tpu.encrypt import Encryptor as JEncryptor, \
        Decryptor as JDecryptor
    from moai_tpu.utils.recrypt import Recryptor as JRecryptor
    jctx = make_context(CKKSConfig(**dataclasses.asdict(CFG)))
    jenc = JEncoder(jctx)
    jkg = JKeyGenerator(jctx, seed=SEED)
    jencryptor = JEncryptor(jctx, jenc, jkg.gen_public_key(), jkg)
    ctx = Context(CFG, device="cpu")
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=SEED, device="cpu")
    encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg, device="cpu")
    return (JRecryptor(jencryptor, JDecryptor(jctx, jenc, jkg.sk)),
            Recryptor(encryptor, Decryptor(ctx, enc, kg.sk, device="cpu")))


@pytest.mark.parametrize("n_in, n_q, scale", [(8, 20, None),
                                              (4, None, 2.0 ** 40)])
def test_recrypt_bit_identical_to_jax(n_in, n_q, scale):
    jrec, rec = _pair()
    vals = np.random.default_rng(n_in).uniform(-1, 1, (3, CFG.slots))
    jct = jrec.encryptor.encrypt_values(vals, n_q=n_in)
    ct = rec.encryptor.encrypt_values(vals, n_q=n_in)
    assert np.array_equal(np.asarray(jct.data).astype(np.int64),
                          ct.data.numpy())
    want = jrec.recrypt(jct, n_q=n_q, scale=scale)
    got = rec.recrypt(ct, n_q=n_q, scale=scale)
    assert got.scale == want.scale and got.n_q == want.n_q
    assert got.n_q == (n_q or rec.encryptor.ctx.L)
    assert np.array_equal(got.data.numpy(),
                          np.asarray(want.data).astype(np.int64))
    assert np.abs(rec.decryptor.decrypt(got).real - vals).max() < 1e-6