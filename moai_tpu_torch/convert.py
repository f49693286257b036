"""Carry the JAX package's objects over to this one.

The JAX package keeps residues as uint32 arrays; this package keeps the same
values in int64 tensors.  Each function takes one of its objects (any
object with the same fields; arrays are read with ``np.asarray``, so jax
arrays and numpy arrays both work) and returns the counterpart here, on
``device`` (CUDA unless the caller asks for the CPU, as every entry point
of this package).  Weights are float numpy in both packages; only their
container type changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ciphertext import Ciphertext, Plaintext
from .keys import GaloisKeys, KSwitchKey, PublicKey, SecretKey
from .params import resolve_device


def tensor(a, device="cuda") -> torch.Tensor:
    """uint32 residues (any array) -> int64 tensor on ``device``."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(
        resolve_device(device))


def ciphertext(ct, device="cuda") -> Ciphertext:
    return Ciphertext(tensor(ct.data, device), float(ct.scale),
                      bool(ct.is_ntt))


def plaintext(pt, device="cuda") -> Plaintext:
    return Plaintext(tensor(pt.data, device), float(pt.scale),
                     bool(pt.is_ntt))


def secret_key(sk, device="cuda") -> SecretKey:
    return SecretKey(np.asarray(sk.coeffs).astype(np.int64),
                     tensor(sk.s_ntt, device))


def public_key(pk, device="cuda") -> PublicKey:
    return PublicKey(tensor(pk.data, device))


def kswitch_key(key, device="cuda") -> KSwitchKey:
    return KSwitchKey(tensor(key.data, device), key.q_limbs)


def galois_keys(gks, device="cuda") -> GaloisKeys:
    return GaloisKeys(
        {int(g): kswitch_key(k, device) for g, k in gks.keys.items()},
        {int(g): np.asarray(p).astype(np.int64) for g, p in gks.perms.items()})


def bert_layer_weights(w):
    """The JAX package's ``BertLayerWeights`` (float64 numpy) -> the
    port's, field by field."""
    from .models.bert import BertLayerWeights
    return BertLayerWeights(**{
        f.name: np.asarray(getattr(w, f.name), np.float64)
        for f in dataclasses.fields(BertLayerWeights)})
