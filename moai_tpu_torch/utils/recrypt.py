"""Test-harness recryption ("cheat bootstrap").

Port of ``moai_tpu/utils/recrypt.py``: a stand-in for bootstrapping while
the model layers are validated.  It holds the secret key, so it lives
strictly on the harness side: no op or model module imports it.  Each
refresh decrypts on the device, decodes and re-encodes on the host, and
encrypts with fresh randomness from the encryptor's DRBG, in the JAX
package's order, so a refreshed ciphertext is bit-identical to the JAX
package's for one seed.
"""

from __future__ import annotations

from ..ciphertext import Ciphertext
from ..encrypt import Encryptor, Decryptor


class Recryptor:
    def __init__(self, encryptor: Encryptor, decryptor: Decryptor):
        self.encryptor = encryptor
        self.decryptor = decryptor

    def recrypt(self, ct: Ciphertext, n_q: int | None = None,
                scale: float | None = None) -> Ciphertext:
        """Decrypt and re-encrypt at (n_q, scale): a bootstrap with zero
        approximation error.  Handles leading batch axes.

        Decrypts the bottom n_q0 + 2 limbs only.  The decode holds the
        message to the int64 window, far inside their product (2^112 at
        the layers' chains), so those limbs give the same integer as all
        of them, or raise as all of them would; the device-to-host copy
        and the host's CRT, which cost per limb, shrink with them: on an
        NVIDIA H100 (700 W) a 768-column refresh of a 20- or 28-limb input
        took 39-44 s, one of a few limbs 17 s."""
        ctx = self.encryptor.ctx
        n_q = n_q if n_q is not None else ctx.L
        scale = scale if scale is not None else ctx.scale
        low = min(ct.n_q, ctx.n_q0 + 2)
        vals = self.decryptor.decrypt(ct.with_data(ct.data[..., :low, :]))
        return self.encryptor.encrypt(
            self.encryptor.encode(vals, scale=scale, n_q=n_q))
