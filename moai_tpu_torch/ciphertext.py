"""Ciphertext/Plaintext containers over int32 residue tensors.

Port of ``moai_tpu/ciphertext.py``.  Data is one tensor in Montgomery form:

    Ciphertext.data: [..., n_polys, n_q, N]
    Plaintext.data:  [..., n_q, N]

Leading batch dimensions are first-class (one batched ciphertext stands for
a vector of ciphertexts).  ``scale`` is the exact float scale and
``is_ntt`` the domain; both are plain Python metadata.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Ciphertext:
    data: torch.Tensor                                # [..., n_polys, n_q, N]
    scale: float
    is_ntt: bool = True

    @property
    def n_polys(self) -> int:
        return self.data.shape[-3]

    @property
    def n_q(self) -> int:
        return self.data.shape[-2]

    @property
    def N(self) -> int:
        return self.data.shape[-1]

    @property
    def batch_shape(self):
        return tuple(self.data.shape[:-3])

    def with_data(self, data) -> "Ciphertext":
        return Ciphertext(data, self.scale, self.is_ntt)


@dataclasses.dataclass
class Plaintext:
    data: torch.Tensor                                # [..., n_q, N]
    scale: float
    is_ntt: bool = True

    @property
    def n_q(self) -> int:
        return self.data.shape[-2]

    @property
    def N(self) -> int:
        return self.data.shape[-1]
