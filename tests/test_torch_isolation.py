"""The port stands alone: no module of ray_tpu_torch, and not chip_smoke.py,
imports jax or any module of the JAX package ray_tpu (module names are
compared exactly: ray_tpu_torch shares the prefix)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN_TOPS = ("jax", "jaxlib", "ray_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_TOPS


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                  "import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_forbidden_name_matching_is_exact():
    assert _forbidden("ray_tpu") and _forbidden("ray_tpu.sched.kernel_jax")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("ray_tpu_torch.sched.kernel_torch")
    assert not _forbidden("jaxlike") and not _forbidden("ray_tpu_torch")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_import(path):
    bad = [(ln, m) for ln, m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("ray_tpu_torch/sched/kernel_torch.py", "ray_tpu_torch/sched/kernel_shard.py",
                 "ray_tpu_torch/sched/policy.py",
                 "ray_tpu_torch/core/runtime.py", "chip_smoke.py"):
        assert must in names


def test_importing_every_module_loads_neither_jax_nor_ray_tpu():
    code = (
        "import importlib, pkgutil, sys, ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, 'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
