"""What a run loads: never JAX nor the JAX package (top-level names
compared whole, so the port, ``moai_tpu_torch``, passes), and the plain
references load nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "moai_tpu")
REFERENCES = sorted(f"fhe_bench.reference.{p.stem}"
                    for p in (BENCH / "reference").glob("*.py")
                    if p.stem != "__init__")


def _loaded(code: str) -> list[str]:
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, pkgutil, sys, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import fhe_bench.run, fhe_bench.capture_work, fhe_bench.readings\n"
        "from fhe_bench import core\n"
        "import moai_tpu_torch\n"
        "for m in pkgutil.walk_packages(moai_tpu_torch.__path__,\n"
        "                               'moai_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "b = core.Bench()\n"
        "for c in b.spec['configs']:\n"
        "    b.kind(b.config(c['name'])['kind'])\n"
        "for m in b.spec['per_layer']:\n"
        "    b.reader(m['name'])\n"
        f"for r in {REFERENCES!r}:\n"
        "    importlib.import_module(r)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    tops = _loaded(code)
    assert "moai_tpu_torch" in tops and "fhe_bench" in tops
    assert not set(tops) & set(FORBIDDEN)


def test_the_references_load_nothing_of_the_port():
    assert {"fhe_bench.reference.ckks", "fhe_bench.reference.head",
            "fhe_bench.reference.boot"} <= set(REFERENCES)
    code = ("import importlib, json, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for r in {REFERENCES!r}:\n"
            "    importlib.import_module(r)\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in "
            "sys.modules})))\n")
    tops = _loaded(code)
    assert "moai_tpu_torch" not in tops
    assert not set(tops) & set(FORBIDDEN)


def test_the_run_checks_top_level_names_whole(monkeypatch):
    from fhe_bench import run
    monkeypatch.setitem(sys.modules, "moai_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "moai_tpu.params", sys)
    assert run.forbidden_modules() == ["moai_tpu"]
