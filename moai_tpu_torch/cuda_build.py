"""Builds the hand-written CUDA sources of ``csrc/`` and loads them.

Each source (``ntt.cu``, ``limb.cu``, ``modmat.cu``) is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
into ``_build/`` beside this file, named by the source's hash (an edited
source rebuilds), and loaded with ctypes.  ``build`` starts one ``nvcc``
per missing library, all at once, and waits for them; ``load`` builds one
source at its first use.  Nothing is compiled or loaded at import: a
machine without the CUDA toolkit imports this module and only fails when a
kernel is asked for.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from .utils import debug

HERE = Path(__file__).resolve().parent
SOURCES = {"ntt": HERE / "csrc" / "ntt.cu", "limb": HERE / "csrc" / "limb.cu",
           "modmat": HERE / "csrc" / "modmat.cu"}
BUILD_DIR = HERE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    tag = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmoai_{name}_{tag}.so"


def build(names=None) -> dict[str, tuple[Path, str]]:
    """Compile every named source (default: all) whose library is missing,
    one nvcc process each, started together, inside a ``cuda_build`` span.
    Returns {name: (library, nvcc's messages)}; the messages (registers,
    shared memory, spills) are empty for a library that was already
    built."""
    names = list(SOURCES) if names is None else list(names)
    out = {name: (library_path(name), "") for name in names
           if library_path(name).exists()}
    missing = [name for name in names if name not in out]
    if not missing:
        return out
    running = {}
    with debug.span("cuda_build"):
        try:
            BUILD_DIR.mkdir(exist_ok=True)
            for name in missing:
                lib = library_path(name)
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                running[name] = (subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(SOURCES[name])],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), tmp, lib)
            for name, (proc, tmp, lib) in running.items():
                _, err = proc.communicate()
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed on {SOURCES[name].name}"
                                       f" ({proc.returncode}):\n{err}")
                os.replace(tmp, lib)
                out[name] = (lib, err)
        finally:
            for proc, _, _ in running.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {name: out[name] for name in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built at first use."""
    return ctypes.CDLL(str(build([name])[name][0]))
