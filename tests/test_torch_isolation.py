"""moai_tpu_torch stands alone: every module imports with JAX and moai_tpu
blocked, its entry points default to CUDA and raise without a card, and
chip_smoke.py fails, printing no result, without a card or without the
package beside it.  Its layers point one way: nothing below parallel/
imports it."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import moai_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    moai_tpu_torch.__path__, "moai_tpu_torch."))


def _run(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _imports(path: Path) -> set:
    """Every module the file at ``path`` imports, anywhere in its code
    (inside functions too), by absolute name; ``from X import y`` counts
    X and X.y."""
    rel = path.relative_to(ROOT).with_suffix("").parts
    package = rel[:-1]
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(package[:len(package) + 1 - node.level]
                            if node.level else ())
            base = ".".join(p for p in (base, node.module) if p)
            out |= {base} | {f"{base}.{a.name}" for a in node.names}
    return out


def test_only_entry_and_parallel_import_parallel():
    """parallel/ sits above boot/, ops/, the evaluator and the rest: only
    entry.py and parallel/ itself import it."""
    pkg = Path(moai_tpu_torch.__file__).parent
    importers = {
        str(path.relative_to(pkg)) for path in pkg.rglob("*.py")
        if any(m.split(".")[:2] == ["moai_tpu_torch", "parallel"]
               for m in _imports(path))}
    assert "entry.py" in importers
    assert {p for p in importers if p != "entry.py"
            and not p.startswith("parallel/")} == set()


def test_every_module_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['moai_tpu'] = None\n"
            "import importlib\n"
            f"for m in {MODULES + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'moai_tpu.'))"
            " for k in sys.modules if sys.modules[k] is not None)\n"
            "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    assert len(MODULES) >= 31
    assert {"moai_tpu_torch.serial", "moai_tpu_torch.utils.debug"} <= \
        set(MODULES)


@pytest.mark.parametrize("entry", ["Context", "KeyGenerator", "Encryptor",
                                   "Evaluator", "build_head",
                                   "build_sharded_head", "build_layer",
                                   "build_model", "serial.load_ciphertext",
                                   "convert.ciphertext"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from moai_tpu_torch.params import Context, test_config as _test_config
    from moai_tpu_torch.keys import KeyGenerator
    from moai_tpu_torch.encrypt import Encryptor
    from moai_tpu_torch.evaluator import Evaluator
    from moai_tpu_torch import convert, serial
    from moai_tpu_torch.ciphertext import Ciphertext
    from moai_tpu_torch.entry import (build_head, build_layer, build_model,
                                      build_sharded_head)
    from moai_tpu_torch.models.bert import BertDims, DepthPlan
    from moai_tpu_torch.parallel.sharding import make_mesh
    ctx = Context(_test_config(), device="cpu")
    calls = {
        "Context": lambda: Context(_test_config()),
        "KeyGenerator": lambda: KeyGenerator(ctx),
        "Encryptor": lambda: Encryptor(ctx, None, None, None),
        "Evaluator": lambda: Evaluator(ctx),
        "build_head": lambda: build_head(9, 12, 32, 8, 8, 8, 2, 2, 3),
        "build_sharded_head": lambda: build_sharded_head(
            9, 12, 32, 8, 8, 8, 2, 2, 3, make_mesh(4, 2, ["cpu"] * 4)),
        "build_layer": lambda: build_layer(
            9, 10, BertDims(32, 8, 8, 2, 4, 16), DepthPlan(2, 2, 1, 0, 8), 3),
        "build_model": lambda: build_model(
            9, 10, BertDims(32, 8, 8, 2, 4, 16), DepthPlan(2, 2, 1, 0, 8), 2,
            3),
        "serial.load_ciphertext": lambda: serial.load_ciphertext(
            "no-such-file"),
        "convert.ciphertext": lambda: convert.ciphertext(
            Ciphertext(np.zeros((2, 3, 8), np.uint32), 1.0)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
