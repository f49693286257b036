"""Versioned serialization for configs, keys, ciphertexts and plaintexts.

Port of ``moai_tpu/serial.py``, in the same format, so each package reads
the other's files: one zip holds ``header.json`` (the kind, ``format_version``
1 and, where given, the full ``CKKSConfig``, from which a load in a fresh
process rebuilds the exact Context) and one ``.npy`` member per array under
the same member names.  Residues are stored as uint32, as the JAX package
holds them; this package holds the same Montgomery values (below 2^30) as
int32 tensors, so a save or a load is a checked reinterpretation of the
same 32-bit words (switching keys load as int64 copies on request,
``dtype=``).

Two departures in how a file is written, none in what it holds:

- members are stored, not deflated: on uniform residues below 2^30 deflate
  saves under 1% of the size at ~25 MB/s, and one BERT-base layer state is
  a 5.64 GB member.  The JAX loader reads stored members as it reads
  deflated ones.
- each ``.npy`` is streamed into its member (ZIP64, so a member may pass
  4 GiB) instead of being built in memory first.

The JAX format keeps a switching key's ``data`` only, so a key sliced to a
prefix of the chain loads back with ``q_limbs=None``, as it does there.
Loaders put tensors on ``device``: CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import zipfile

import numpy as np
import torch

from .ciphertext import Ciphertext, Plaintext
from .keys import GaloisKeys, KSwitchKey, PublicKey, SecretKey
from .params import CKKSConfig, Context, resolve_device

FORMAT_VERSION = 1


def _cfg_dict(cfg: CKKSConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["q0_bits"] = list(d["q0_bits"])
    return d


def _cfg_from_dict(d: dict) -> CKKSConfig:
    d = dict(d)
    d["q0_bits"] = tuple(d["q0_bits"])
    return CKKSConfig(**d)


def _host(a) -> np.ndarray:
    """A residue tensor (int32, or int64 with the same values; any device)
    -> uint32 numpy, after checking that every value lies in [0, 2^31); a
    numpy array (key coefficients, Galois permutations) as it is."""
    if isinstance(a, torch.Tensor):
        if a.numel() and (int(a.min()) < 0 or int(a.max()) >= 1 << 31):
            raise ValueError("residues outside [0, 2^31)")
        return a.to(torch.int32).cpu().numpy().view(np.uint32)
    return np.asarray(a)


def _save(path: str, header: dict, arrays: dict) -> None:
    header = dict(header)
    header["format_version"] = FORMAT_VERSION
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("header.json", json.dumps(header))
        for name, arr in arrays.items():
            with z.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _host(arr), allow_pickle=False)


@contextlib.contextmanager
def _load(path: str, kind: str):
    """-> (header, read(name) -> numpy array), the file open meanwhile."""
    with zipfile.ZipFile(path, "r") as z:
        header = json.loads(z.read("header.json"))
        if header["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"file format {header['format_version']} is newer than "
                f"supported {FORMAT_VERSION}")
        if header["kind"] != kind:
            raise ValueError(f"{path} holds a {header['kind']}, not a {kind}")

        def read(name: str) -> np.ndarray:
            with z.open(name + ".npy") as f:
                return np.lib.format.read_array(f, allow_pickle=False)
        yield header, read


def _residues(a: np.ndarray, device, dtype=torch.int32) -> torch.Tensor:
    """uint32 residues -> a tensor of ``dtype`` on ``device``: the int32
    view of the same words, checked on ``device`` to be non-negative (every
    residue is below 2^30, so the view is the same number)."""
    if a.dtype != np.uint32:
        raise ValueError(f"residues stored as {a.dtype}, not uint32")
    t = torch.from_numpy(a.view(np.int32)).to(device)
    if t.numel() and int(t.min()) < 0:
        raise ValueError("a stored residue is at or above 2^31")
    return t.to(dtype)


# -- context ----------------------------------------------------------------

def save_config(path: str, cfg: CKKSConfig) -> None:
    _save(path, {"kind": "config", "config": _cfg_dict(cfg)}, {})


def load_context(path: str, device="cuda") -> Context:
    with _load(path, "config") as (h, _):
        return Context(_cfg_from_dict(h["config"]), device=device)


# -- ciphertext / plaintext ---------------------------------------------------

def save_ciphertext(path: str, ct: Ciphertext,
                    cfg: CKKSConfig | None = None) -> None:
    h = {"kind": "ciphertext", "scale": ct.scale, "is_ntt": ct.is_ntt}
    if cfg is not None:
        h["config"] = _cfg_dict(cfg)
    _save(path, h, {"data": ct.data})


def load_ciphertext(path: str, device="cuda") -> Ciphertext:
    dev = resolve_device(device)
    with _load(path, "ciphertext") as (h, read):
        return Ciphertext(_residues(read("data"), dev), float(h["scale"]),
                          bool(h["is_ntt"]))


def save_plaintext(path: str, pt: Plaintext) -> None:
    _save(path, {"kind": "plaintext", "scale": pt.scale,
                 "is_ntt": pt.is_ntt}, {"data": pt.data})


def load_plaintext(path: str, device="cuda") -> Plaintext:
    dev = resolve_device(device)
    with _load(path, "plaintext") as (h, read):
        return Plaintext(_residues(read("data"), dev), float(h["scale"]),
                         bool(h["is_ntt"]))


# -- keys ---------------------------------------------------------------------

def save_secret_key(path: str, sk: SecretKey) -> None:
    _save(path, {"kind": "secret_key"},
          {"coeffs": np.asarray(sk.coeffs, np.int64), "s_ntt": sk.s_ntt})


def load_secret_key(path: str, device="cuda") -> SecretKey:
    dev = resolve_device(device)
    with _load(path, "secret_key") as (_, read):
        return SecretKey(read("coeffs").astype(np.int64),
                         _residues(read("s_ntt"), dev))


def save_public_key(path: str, pk: PublicKey) -> None:
    _save(path, {"kind": "public_key"}, {"data": pk.data})


def load_public_key(path: str, device="cuda") -> PublicKey:
    dev = resolve_device(device)
    with _load(path, "public_key") as (_, read):
        return PublicKey(_residues(read("data"), dev))


def save_kswitch_key(path: str, key: KSwitchKey) -> None:
    _save(path, {"kind": "kswitch_key"}, {"data": key.data})


def load_kswitch_key(path: str, device="cuda",
                     dtype: torch.dtype = torch.int32) -> KSwitchKey:
    dev = resolve_device(device)
    with _load(path, "kswitch_key") as (_, read):
        return KSwitchKey(_residues(read("data"), dev, dtype))


def save_galois_keys(path: str, gks: GaloisKeys) -> None:
    elts = sorted(gks.keys)
    arrays = {}
    for g in elts:
        arrays[f"key_{g}"] = gks.keys[g].data
        arrays[f"perm_{g}"] = np.asarray(gks.perms[g], np.int64)
    _save(path, {"kind": "galois_keys", "elts": elts}, arrays)


def load_galois_keys(path: str, device="cuda",
                     dtype: torch.dtype = torch.int32) -> GaloisKeys:
    dev = resolve_device(device)
    keys, perms = {}, {}
    with _load(path, "galois_keys") as (h, read):
        for g in h["elts"]:
            keys[g] = KSwitchKey(_residues(read(f"key_{g}"), dev, dtype))
            perms[g] = read(f"perm_{g}").astype(np.int64)
    return GaloisKeys(keys, perms)


# -- checkpoint / resume ------------------------------------------------------

def save_layer_state(path: str, ct: Ciphertext, layer_idx: int,
                     cfg: CKKSConfig | None = None) -> None:
    """Checkpoint a model's inter-layer ciphertext: the output of
    ``layers[layer_idx]``, ready to enter ``layers[layer_idx + 1]``.  The
    checkpoint is the ciphertext itself, resumable without the secret
    key."""
    h = {"kind": "layer_state", "layer_idx": int(layer_idx),
         "scale": ct.scale, "is_ntt": ct.is_ntt}
    if cfg is not None:
        h["config"] = _cfg_dict(cfg)
    _save(path, h, {"data": ct.data})


def load_layer_state(path: str, device="cuda") -> tuple[Ciphertext, int]:
    """-> (ciphertext, layer_idx).  Resume with
    ``EncryptedBertModel(...)(ct, start_layer=layer_idx + 1)``."""
    dev = resolve_device(device)
    with _load(path, "layer_state") as (h, read):
        ct = Ciphertext(_residues(read("data"), dev), float(h["scale"]),
                        bool(h["is_ntt"]))
        return ct, int(h["layer_idx"])
