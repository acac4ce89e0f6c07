"""The port stands alone: no module of ray_tpu_torch, and not chip_smoke.py,
imports jax or any module of the JAX package ray_tpu (module names are
compared exactly: ray_tpu_torch shares the prefix), and no string constant
names one as code: Python source handed to ``-c`` or ``exec``, a module
handed to ``-m``, or an importlib / ``module:attr`` path (a spawned head,
daemon, job or gateway call would import it where the AST walk cannot
see). Docstrings and prose such as ``ray_tpu/dashboard/head.py`` are not
code and do not count."""

import ast
import pathlib
import re
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


# an import statement inside a string: "from ray_tpu.x import y", "import jax"
_CODE_IMPORT = re.compile(r"(?:^|[\s;(\"'])(?:from|import)\s+([A-Za-z_]\w*)")
# a whole string that is a dotted module path or a module:attr path
_MODULE_PATH = re.compile(r"^([A-Za-z_]\w*)(?:\.\w+)*(?::[\w.]+)?$")


def _docstring_nodes(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                out.add(id(first.value))
    return out


def _string_code_modules(source: str):
    """(line, module) for each string constant of `source` that names a
    module as code: an import statement in a string, a dotted or
    ``module:attr`` path (a bare name counts only after ``-m``)."""
    tree = ast.parse(source)
    docs = _docstring_nodes(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = node.elts
            for a, b in zip(elts, elts[1:]):
                if (isinstance(a, ast.Constant) and a.value == "-m"
                        and isinstance(b, ast.Constant) and isinstance(b.value, str)):
                    yield b.lineno, b.value.strip()
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)) \
                or id(node) in docs:
            continue
        for m in _CODE_IMPORT.finditer(node.value):
            yield node.lineno, m.group(1)
        text = node.value.strip()
        m = _MODULE_PATH.match(text)
        if m and ("." in text or ":" in text):
            yield node.lineno, text.partition(":")[0]


def test_forbidden_name_matching_is_exact():
    assert _forbidden("ray_tpu") and _forbidden("ray_tpu.sched.kernel_jax")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("ray_tpu_torch.sched.kernel_torch")
    assert not _forbidden("jaxlike") and not _forbidden("ray_tpu_torch")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_import(path):
    bad = [(ln, m) for ln, m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_named_in_code_strings(path):
    bad = [(ln, m) for ln, m in _string_code_modules(path.read_text()) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} names as code {bad}"


def test_code_string_rule_catches_planted_strings():
    """Each planted string is caught; prose and the port's own names are not."""
    planted = (
        'import subprocess, sys\n'
        'SRC = "from ray_tpu.cluster.gcs import GcsServer\\ng = GcsServer()"\n'
        'subprocess.Popen([sys.executable, "-m", "ray_tpu.cluster.node_daemon"])\n'
        'subprocess.Popen([sys.executable, "-m", "ray_tpu", "job"])\n'
        'FUNC = "ray_tpu.util.state.api:list_nodes"\n'
        'MOD = "jax.numpy"\n'
        'exec("import jax; jax.devices()")\n'
        'BOTH = "x = 1; import ray_tpu"\n'
    )
    found = {(ln, m) for ln, m in _string_code_modules(planted) if _forbidden(m)}
    assert found == {(2, "ray_tpu"), (3, "ray_tpu.cluster.node_daemon"), (4, "ray_tpu"),
                     (5, "ray_tpu.util.state.api"), (6, "jax.numpy"), (7, "jax"),
                     (8, "ray_tpu")}
    clean = (
        '"""Mirrors ray_tpu/dashboard/head.py; from ray_tpu. in a docstring."""\n'
        'import subprocess, sys\n'
        'SRC = "from ray_tpu_torch.cluster.gcs import GcsServer"\n'
        'subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.cluster.node_daemon"])\n'
        'FUNC = "ray_tpu_torch.util.state.api:list_nodes"\n'
        'EVENT = {"source": "ray_tpu", "path": "ray_tpu/autoscaler/launcher.py"}\n'
        'MSG = "the reference (ray_tpu) frees the object"\n'
    )
    assert not [m for _, m in _string_code_modules(clean) if _forbidden(m)]


def test_package_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("ray_tpu_torch/sched/kernel_torch.py", "ray_tpu_torch/sched/kernel_shard.py",
                 "ray_tpu_torch/sched/policy.py",
                 "ray_tpu_torch/core/runtime.py", "chip_smoke.py",
                 "ray_tpu_torch/autoscaler/launcher.py",
                 "ray_tpu_torch/dashboard/head.py"):
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
