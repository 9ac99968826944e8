"""The port stands alone: no file under src/repro_torch/, and not
chip_smoke.py, imports ``jax`` or anything of ``repro``, or names such a
module in a string (a forkserver preload, a ``"module:attr"`` factory
target), where no import statement shows it."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import numpy as np  # noqa: F401
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")
# A string that is a dotted module name, optionally with ":attr".
MODULE_STRING = re.compile(r"[A-Za-z_]\w*(\.\w+)*(:[\w.]+)?")


def _imports(path: Path):
    """Absolute module names a file imports; relative imports are resolved
    against the file's package, so one that climbs out of repro_torch shows."""
    pkg = list(path.relative_to(ROOT / "src").parent.parts) if PKG in path.parents else []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert node.level <= len(pkg), f"{path}: relative import leaves the package"
                base = pkg[:len(pkg) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def _module_strings(path: Path):
    """String constants that name a module: ``"a.b"`` or ``"a.b:attr"``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if "." in node.value or ":" in node.value:
                if MODULE_STRING.fullmatch(node.value):
                    yield node.value


def test_the_scan_sees_every_file():
    assert (ROOT / "chip_smoke.py").exists()
    names = {p.relative_to(PKG).as_posix() for p in FILES if PKG in p.parents}
    assert {"kernels/ops.py", "kernels/rwkv6_scan.py", "kernels/rglru_scan.py",
            "kernels/moe_router.py", "models/layers.py", "models/rwkv6.py",
            "models/rglru.py", "models/moe.py", "launch/serve.py",
            "core/workers.py", "core/experiment.py", "launch/tune.py",
            "cluster/executor.py", "cluster/worker.py", "testing/scenarios.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_string_names_a_jax_or_repro_module(path):
    for name in _module_strings(path):
        top = re.split(r"[.:]", name)[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} names the module {name!r}"


@pytest.mark.parametrize("text,names", [
    ('ctx.set_forkserver_preload(["repro.core.workers"])', ["repro.core.workers"]),
    ('T(target="repro.train.trainable:make_model_trainable")',
     ["repro.train.trainable:make_model_trainable"]),
    ('"""Docs that mention repro.core."""\nx = "a sentence. Not a module"', []),
])
def test_the_string_scan_finds_module_names(tmp_path, text, names):
    (tmp_path / "m.py").write_text(text)
    assert list(_module_strings(tmp_path / "m.py")) == names


def test_serve_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch.serve, repro_torch.models.convert, "
            "repro_torch.launch.tune, repro_torch.cluster, repro_torch.testing.kill9; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
