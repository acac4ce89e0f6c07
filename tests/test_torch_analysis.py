"""The port's analysis plane (ray_tpu_torch/analysis) against the JAX
package's (ray_tpu/analysis) on the same inputs.

- Findings: every snippet the reference's own tests lint
  (``tests/test_analysis.py``) is linted by both packages' checkers, with
  the package name rewritten in each direction, and the findings (check,
  line, column, message) must be equal. The reference test runs as it is;
  a spy on its ``analyze_paths`` mirrors each call onto the port.
- The protocol model, the state machines and the lock-order sanitizer
  equal the reference's, up to the differences stated in
  ``PROTOCOL_DIFFERENCES``.
- The gate: the port's CLI over ``ray_tpu_torch/`` reports no finding
  against an empty baseline.

``parity_params`` / ``run_with_parity`` are imported by the port's other
analysis test files (by module name, never through ``tests.``).
"""

import collections
import contextlib
import inspect
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import textwrap
import types

import pytest
import torch

import test_analysis as REF_TESTS
from ray_tpu.analysis import protocol as ref_protocol
from ray_tpu.analysis import statemachine as ref_sm
from ray_tpu_torch.analysis import CHECKERS, analyze_paths, load_baseline
from ray_tpu_torch.analysis import checkers as port_checkers
from ray_tpu_torch.analysis import protocol as port_protocol
from ray_tpu_torch.analysis import statemachine as port_sm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, ".ray-lint-baseline.json")
PORT = "ray_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Under the suite's xdist workers torch's intra-op threads spin
    against each other; one thread for this module, the count restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the parity harness

_REF_WORD = re.compile(r"\bray_tpu\b")


def to_port(text: str) -> str:
    """The reference's package name rewritten to the port's."""
    return _REF_WORD.sub(PORT, text)


def to_ref(text: str) -> str:
    return text.replace(PORT, "ray_tpu")


def _inside(path: str, base: str) -> bool:
    ap = os.path.abspath(path)
    return ap == base or ap.startswith(base + os.sep)


def _mirror_tree(base: str) -> str:
    """A copy of every file under `base` in a new directory beside it,
    with `ray_tpu` renamed to the port's package in path components and
    in .py sources."""
    dst = tempfile.mkdtemp(prefix="port_", dir=os.path.dirname(base))
    for dirpath, _dirs, files in os.walk(base):
        rel = os.path.relpath(dirpath, base)
        parts = [] if rel == "." else [
            PORT if p == "ray_tpu" else p for p in rel.split(os.sep)]
        out_dir = os.path.join(dst, *parts)
        os.makedirs(out_dir, exist_ok=True)
        for name in files:
            src = os.path.join(dirpath, name)
            out = os.path.join(out_dir, name)
            if name.endswith(".py"):
                with open(src, encoding="utf-8") as f:
                    text = f.read()
                with open(out, "w", encoding="utf-8") as f:
                    f.write(to_port(text))
            else:
                shutil.copyfile(src, out)
    return dst


def _mirror_path(path: str, base: str, mbase: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), base)
    if rel == ".":
        return mbase
    return os.path.join(mbase, *[PORT if p == "ray_tpu" else p
                                 for p in rel.split(os.sep)])


def _norm_text(text: str, base: str) -> str:
    return to_ref(text.replace(base, "<base>"))


def _norm_obj(obj, base: str):
    if isinstance(obj, dict):
        return {_norm_text(str(k), base): _norm_obj(v, base)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_norm_obj(x, base) for x in obj]
    if isinstance(obj, str):
        return _norm_text(obj, base)
    return obj


def _ref_col(path: str, line: int, col: int) -> int:
    """`col` on the port's copy of a line, as a column of the reference's
    line: each earlier `ray_tpu_torch` on the line is 6 characters longer."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read().splitlines()[line - 1]
    except (OSError, IndexError):
        return col
    return col - (len(PORT) - len("ray_tpu")) * text[:col].count(PORT)


def norm_analysis(res, root: str, base: str):
    """An AnalysisResult as comparable data: findings by path relative to
    the fixture directory, line, column, check and message."""
    findings = []
    for f in res.findings:
        full = os.path.normpath(os.path.join(root, f.path))
        path = os.path.relpath(full, base)
        findings.append((_norm_text(path, base), f.line, _ref_col(full, f.line, f.col),
                         f.check, _norm_text(f.message, base)))
    return {"findings": sorted(findings), "suppressed": res.suppressed,
            "files_scanned": res.files_scanned, "errors": len(res.errors)}


def norm_report(report, root: str, base: str):
    """An rpcflow / waitgraph report (anything with to_dict) as data."""
    return _norm_obj(json.loads(json.dumps(report.to_dict(), default=str)), base)


TESTS = os.path.dirname(os.path.abspath(__file__))


def run_child(lines, timeout: float = 120.0):
    """Run the code `lines` in a fresh interpreter (the repo and the tests
    directory on its path) and return its last printed line, parsed as
    JSON. Every case that installs a sanitizer runs this way: one that
    hangs is killed at `timeout` and fails alone instead of stalling its
    xdist worker, and no case runs under another's patched `threading`."""
    code = "\n".join(["import json, sys", f"sys.path.insert(0, {TESTS!r})", *lines])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_rebound(module: str, name: str, names: str, fixture: str = "",
                timeout: float = 120.0):
    """The reference test `module.name` run by `run_child` with its module's
    names bound to the port's: `names` is code that fills ``NAMES``;
    `fixture`, code that makes the case's argument ``fx`` (a sanitizer,
    uninstalled after)."""
    run_child([
        "import importlib, types",
        f"ref = importlib.import_module({module!r})",
        "NAMES = {}",
        names,
        f"fn = getattr(ref, {name!r})",
        "g = dict(fn.__globals__)",
        "g.update(NAMES)",
        "f = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)",
        "fx = None",
        fixture,
        "try:",
        "    f() if fx is None else f(fx)",
        "finally:",
        "    if fx is not None:",
        "        fx.uninstall()",
        "print(json.dumps('ok'))",
    ], timeout)


def rebound(fn, **names):
    """The reference test `fn`, its module's `names` bound to the port's
    objects: the reference's own assertions, held against the port."""
    g = dict(fn.__globals__)
    g.update(names)
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


def plain_tests(module, params=(), exclude=()):
    """Names of `module`'s test functions whose parameters are exactly
    `params` and whose source names no module of the reference package
    (those bodies would import the reference where the port is meant)."""
    out = []
    for name, fn in sorted(vars(module).items()):
        if not (name.startswith("test_") and inspect.isfunction(fn)) or name in exclude:
            continue
        if tuple(inspect.signature(fn).parameters) != tuple(params):
            continue
        if "ray_tpu" not in inspect.getsource(fn):
            out.append(name)
    return out


def parity_params(module, helpers):
    """Names of `module`'s test functions that take only `tmp_path` and
    call one of `helpers`: the tests whose fixture sources the port's
    tools are held to."""
    out = []
    for name, fn in sorted(vars(module).items()):
        if not (name.startswith("test_") and inspect.isfunction(fn)):
            continue
        if list(inspect.signature(fn).parameters) != ["tmp_path"]:
            continue
        src = inspect.getsource(fn)
        if any(re.search(rf"\b{h}\(", src) for h in helpers):
            out.append(name)
    return out


def run_with_parity(monkeypatch, tmp_path, module, test_name, spies):
    """Run the reference test `module.test_name` as it is, with each
    ``spies[attr] = (port_fn, normalize)`` wrapping ``module.attr``: every
    call that reads only the test's own files is mirrored onto the port's
    `port_fn`, and the two normalized results must be equal. Returns the
    number of calls compared."""
    base = os.path.abspath(str(tmp_path))
    compared = []
    diffs = []

    def make_spy(attr, ref_fn, port_fn, normalize):
        def spy(paths, root=None, **kw):
            inside = all(_inside(p, base) for p in list(paths) + ([root] if root else []))
            if inside:
                mbase = _mirror_tree(base)
                mpaths = [_mirror_path(p, base, mbase) for p in paths]
                mroot = _mirror_path(root, base, mbase) if root else None
            try:
                res = ref_fn(paths, root=root, **kw)
            except Exception as e:
                if inside:  # the port must refuse the same input alike
                    with pytest.raises(type(e)):
                        port_fn(mpaths, root=mroot, **kw)
                    compared.append(attr)
                raise
            if not inside:
                return res
            pres = port_fn(mpaths, root=mroot, **kw)
            want = normalize(res, os.path.abspath(root or os.getcwd()), base)
            got = normalize(pres, os.path.abspath(mroot or os.getcwd()), mbase)
            compared.append(attr)
            if want != got:
                diffs.append((attr, want, got))
            return res
        return spy

    for attr, (port_fn, normalize) in spies.items():
        monkeypatch.setattr(module, attr,
                            make_spy(attr, getattr(module, attr), port_fn, normalize))
    getattr(module, test_name)(tmp_path)
    assert not diffs, json.dumps(diffs[0], indent=1, default=str)[:4000]
    return len(compared)


# ------------------------------------------------------------ the findings

LINT_TESTS = parity_params(REF_TESTS, ("lint", "_lint_two", "_lint_config",
                                       "analyze_paths"))


def test_parity_cases_were_found():
    assert len(LINT_TESTS) >= 50


@pytest.mark.parametrize("name", LINT_TESTS)
def test_checker_findings_equal_reference(name, tmp_path, monkeypatch):
    n = run_with_parity(monkeypatch, tmp_path, REF_TESTS, name,
                        {"analyze_paths": (analyze_paths, norm_analysis)})
    assert n >= 1, f"{name} linted nothing the port could mirror"


def test_checker_registry_equals_reference():
    from ray_tpu.analysis import CHECKERS as REF_CHECKERS

    assert sorted(CHECKERS) == sorted(REF_CHECKERS)
    for name, cls in CHECKERS.items():
        want = REF_CHECKERS[name].description
        if name == "unsafe-closure-capture":
            want = want.replace("device array", "device tensor")
        assert cls.description == want, name


def test_valid_options_match_runtime_api():
    """The checker cannot import the runtime, so its copy of @remote's
    options is held to the port's api by this test."""
    from ray_tpu_torch.core import api

    assert port_checkers._VALID_OPTIONS == api._VALID_OPTIONS


def _lint_src(tmp_path, source, select):
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent(source))
    res = analyze_paths([str(p)], root=str(tmp_path), select=select)
    assert not res.errors, res.errors
    return res.findings


@pytest.mark.parametrize("make", [
    'torch.empty(8, device="cuda")',
    "torch.tensor([1.0, 2.0], device=dev)",
    'torch.as_tensor(arr, device=torch.device("cuda"))',
    'torch.zeros(4, dtype=torch.int32, device="cuda:0")',
])
def test_remote_closure_capturing_cuda_tensor_fires(tmp_path, make):
    """The reference flags a captured `jax.device_put` array; the port
    flags a tensor made on a device, the way its own code puts arrays on
    the card."""
    found = _lint_src(tmp_path, f"""
        import torch
        import ray_tpu_torch

        def driver(arr, dev):
            buf = {make}

            @ray_tpu_torch.remote
            def task():
                return buf.sum()

            return task.remote()
        """, ["unsafe-closure-capture"])
    assert [f.check for f in found] == ["unsafe-closure-capture"]
    assert "device tensor" in found[0].message and "`buf`" in found[0].message


@pytest.mark.parametrize("make", [
    "torch.empty(8)",
    'torch.zeros(4, device="cpu")',
    "torch.as_tensor(arr)",
])
def test_remote_closure_capturing_cpu_tensor_is_clean(tmp_path, make):
    found = _lint_src(tmp_path, f"""
        import torch
        from ray_tpu_torch import remote

        def driver(arr):
            buf = {make}

            @remote
            def task():
                return buf.sum()

            return task.remote()
        """, ["unsafe-closure-capture"])
    assert found == []


# ------------------------------------------------------------------ the gate


def test_repo_is_clean():
    """Tier-1 gate of the port: the port's CLI over ray_tpu_torch/ reports
    no finding against the committed (empty) baseline, which it reads and
    never writes."""
    with open(BASELINE, "rb") as f:
        before = f.read()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.analysis", "ray_tpu_torch",
         "--format", "json", "--baseline", BASELINE],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    with open(BASELINE, "rb") as f:
        assert f.read() == before
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["new"] == [], json.dumps(data["new"], indent=2)
    assert data["baselined"] == []
    assert data["errors"] == []
    assert data["files_scanned"] > 100
    assert load_baseline(BASELINE) == {}


# ------------------------------------------------- protocol and state machines

#: What the port's extracted protocol lacks or adds against the
#: reference's, each with its cause. Any other difference fails.
PROTOCOL_DIFFERENCES = {}
#: config keys only the port defines: ray_tpu_torch/core/config.py:32
PORT_ONLY_CONFIG_KEYS = {"scheduler_device"}


@pytest.fixture(scope="module")
def protocols():
    ref = ref_protocol.extract_protocol([os.path.join(REPO, "ray_tpu")], root=REPO)
    port = port_protocol.extract_protocol([os.path.join(REPO, PORT)], root=REPO)
    return ref, port


def _strip_lines(obj):
    """Line numbers differ between the copies; everything else must not."""
    if isinstance(obj, dict):
        return {k: _strip_lines(v) for k, v in obj.items() if k != "line"}
    if isinstance(obj, list):
        return [_strip_lines(x) for x in obj]
    if isinstance(obj, str):
        return to_ref(obj)
    return obj


def _entries(model, section):
    return collections.Counter(json.dumps(x, sort_keys=True) for x in model[section])


@pytest.mark.parametrize("section", ["calls", "pushes", "subscriptions"])
def test_protocol_section_equals_reference(protocols, section):
    ref, port = (_strip_lines(p.to_dict()) for p in protocols)
    want, got = _entries(ref, section), _entries(port, section)
    for (sec, method, path), delta in PROTOCOL_DIFFERENCES.items():
        if sec != section:
            continue
        matching = [k for k in want if json.loads(k).get("method") == method
                    and json.loads(k).get("path") == path]
        assert sum(want[k] for k in matching) == -delta
        for k in matching:
            del want[k]
    assert got - want == collections.Counter()
    assert want - got == collections.Counter()


def test_protocol_handlers_equal_reference(protocols):
    ref, port = (_strip_lines(p.to_dict()) for p in protocols)
    assert port["handlers"] == ref["handlers"]
    assert len(port["handlers"]) >= 40


def test_protocol_config_equals_reference(protocols):
    ref, port = (_strip_lines(p.to_dict()) for p in protocols)
    assert set(port["config"]["defined"]) - set(ref["config"]["defined"]) \
        == PORT_ONLY_CONFIG_KEYS
    assert set(ref["config"]["defined"]) <= set(port["config"]["defined"])
    assert port["config"]["defs_path"] == ref["config"]["defs_path"]
    assert _entries(port["config"], "uses") == _entries(ref["config"], "uses")


def test_state_machines_equal_reference(protocols):
    ref, port = (_strip_lines(p.to_dict()) for p in protocols)
    assert port["statemachines"]["declared"] == ref["statemachines"]["declared"]
    assert _entries(port["statemachines"], "writes") == \
        _entries(ref["statemachines"], "writes")
    assert sorted(port_sm.MACHINES) == sorted(ref_sm.MACHINES)


def test_dump_protocol_roundtrips_method_table(protocols):
    """Every rpc method the port's dynamic invariant checker models exists
    in the static protocol extracted from the port's own tree."""
    from ray_tpu_torch.analysis.invariants import METHOD_TABLE

    idx = protocols[1]
    missing = sorted(set(METHOD_TABLE) - idx.handler_methods())
    assert not missing, f"METHOD_TABLE methods without handlers: {missing}"
    assert len(idx.calls) >= 50
    assert idx.subscribed_topics() >= {"task_result", "exec_tasks", "nodes"}
    assert "rpc_call_timeout_s" in idx.config_keys


def test_dump_protocol_cli_emits_json():
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.analysis", "ray_tpu_torch/cluster",
         "--dump-protocol"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    model = json.loads(proc.stdout)
    h = model["handlers"]["submit_task"][0]
    assert h["server"] == "gcs" and "task_id" in h["required"]
    assert h["path"] == "ray_tpu_torch/cluster/gcs.py"


# ------------------------------------------------- the lock-order sanitizer


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_lock_order_sanitizer_finds_the_same_inversion(package):
    """tests/test_analysis.py's inversion: a -> b on one thread, b -> a on
    another, run one after the other (locks are keyed by allocation site,
    so they are made on two lines)."""
    cycles = run_child([
        "import threading",
        f"from {package}.analysis.sanitizer import LockOrderSanitizer",
        "san = LockOrderSanitizer().install()",
        "try:",
        "    a = threading.Lock()",
        "    b = threading.Lock()",
        "    def fwd():",
        "        with a:",
        "            with b:",
        "                pass",
        "    def rev():",
        "        with b:",
        "            with a:",
        "                pass",
        "    for fn in (fwd, rev):",
        "        t = threading.Thread(target=fn)",
        "        t.start()",
        "        t.join(10)",
        "finally:",
        "    san.uninstall()",
        "print(json.dumps(san.cycles()))",
    ])
    assert len(cycles) == 1 and len(cycles[0]) == 2


def test_lock_order_sanitizer_restores_factories():
    same = run_child([
        "import threading",
        "from ray_tpu_torch.analysis.sanitizer import LockOrderSanitizer",
        "before = (threading.Lock, threading.RLock, threading.Condition)",
        "LockOrderSanitizer().install().uninstall()",
        "print(json.dumps((threading.Lock, threading.RLock, threading.Condition) == before))",
    ])
    assert same is True


def test_cli_list_checks_equals_reference():
    from ray_tpu.analysis.__main__ import main as ref_main
    from ray_tpu_torch.analysis.__main__ import main as port_main

    outs = []
    for main in (ref_main, port_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--list-checks"]) == 0
        outs.append(to_ref(buf.getvalue()).replace("device tensor", "device array"))
    assert outs[0] == outs[1]
