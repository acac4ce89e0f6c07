"""Analysis framework core: findings, pragmas, checker registry, baseline.

The distributed-correctness linter walks Python ASTs with small visitor
classes (one per check) registered in a plugin table, mirroring how the
reference hardens its C++ core-worker/raylet layer with clang-tidy plugins
and TSAN annotations — here the failure surface is hand-rolled Python
concurrency (per-actor asyncio loops, threaded RPC/GCS loops, lock-guarded
stores), so the checks target *distributed* correctness: blocking calls on
event loops, unserializable closure captures, lock-order cycles, dropped
ObjectRefs, and resource specs the scheduler can never satisfy.

Suppression: per-line ``# ray-lint: disable=<check>[,<check>...]`` pragmas
(``disable=all`` wildcard), or ``# ray-lint: skip-file`` anywhere in a file.
A committed JSON baseline grandfathers known findings by content
fingerprint (path + check + stripped source line + occurrence ordinal),
so moved code keeps its baseline entry but *new* violations — including a
second copy of an already-baselined line — always fail.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Finding:
    path: str  # relative to the analysis root
    line: int
    col: int
    check: str
    message: str
    line_text: str = ""  # stripped source line, for fingerprinting
    # Ordinal among findings with identical (path, check, line_text),
    # assigned by analyze_paths. Without it, a *new* violation textually
    # identical to a baselined one in the same file would silently ride
    # the grandfathered entry, defeating the ratchet.
    occurrence: int = 0
    # Last physical line of the flagged node (= line for single-line
    # nodes); pragma lookup covers the whole range. Not fingerprinted.
    end_line: int = 0

    def fingerprint(self) -> str:
        # Content-addressed (no line number): moving code keeps the
        # baseline entry; editing the flagged line — or adding another
        # identical violation — makes a finding new.
        h = hashlib.sha1(
            f"{self.path}::{self.check}::{self.line_text}"
            f"::{self.occurrence}".encode()
        )
        return h.hexdigest()[:16]

    def to_dict(self) -> Dict:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "check": self.check,
            "message": self.message,
            "fingerprint": self.fingerprint(),
        }

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.check}] {self.message}"


# --------------------------------------------------------------------- pragmas

_PRAGMA_RE = re.compile(
    r"#\s*ray-lint:\s*(disable|skip-file)\b(?:\s*=\s*([\w\-,\s]+))?"
)


class Pragmas:
    """Per-line suppression table parsed from source comments.

    Only real COMMENT tokens count: a docstring that *documents* the
    pragma syntax (as this module's does) must not suppress anything."""

    def __init__(self, source: str):
        self.skip_file = False
        self.by_line: Dict[int, set] = {}
        try:
            comments = [
                (tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(io.StringIO(source).readline)
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            comments = []  # unparseable files surface as errors elsewhere
        for lineno, text in comments:
            m = _PRAGMA_RE.search(text)
            if not m:
                continue
            kind, arg = m.group(1), m.group(2)
            if kind == "skip-file":
                self.skip_file = True
            elif arg:
                checks = {c.strip() for c in arg.split(",") if c.strip()}
                self.by_line.setdefault(lineno, set()).update(checks)

    def suppressed(self, finding: Finding) -> bool:
        if self.skip_file:
            return True
        # A multi-line statement can carry its pragma on any of its
        # physical lines (typically the closing one), so honor the
        # finding's whole lineno..end_lineno range.
        for lineno in range(finding.line, max(finding.line, finding.end_line) + 1):
            checks = self.by_line.get(lineno)
            if checks and ("all" in checks or finding.check in checks):
                return True
        return False


# -------------------------------------------------------------------- checkers


class ModuleContext:
    """Everything a checker needs about one parsed file."""

    def __init__(self, path: str, relpath: str, source: str, tree: ast.AST):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.modname = os.path.splitext(os.path.basename(path))[0]

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, node: ast.AST, check: str, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            path=self.relpath,
            line=line,
            col=col,
            check=check,
            message=message,
            line_text=self.line_text(line),
            end_line=getattr(node, "end_lineno", None) or line,
        )


class Checker:
    """Base checker. One instance lives for the whole run: per-module state
    goes through ``check_module``; whole-program checks (the lock graph)
    accumulate there and emit from ``finalize``."""

    name: str = ""
    description: str = ""

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        return []

    def finalize(self) -> List[Finding]:
        return []


CHECKERS: Dict[str, type] = {}


def register(cls):
    """Plugin-table registration decorator for checker classes."""
    assert cls.name, "checker must define a name"
    CHECKERS[cls.name] = cls
    return cls


def chan_word_of(node: ast.AST) -> Optional[str]:
    """Layout name of a channel-header word constant (``_W_VERSION`` /
    ``W_CAP`` -> "version" / "capacity"), else None. The ONE recognizer
    shared by the chan-publication-order checker and memmodel's
    op-sequence extraction — two copies would let the lint and the
    round-trip gate diverge on what counts as a word reference."""
    if isinstance(node, ast.Name) and node.id.startswith(("_W_", "W_")):
        name = node.id.split("W_", 1)[1].lower()
        return {"cap": "capacity"}.get(name, name)
    return None


# ----------------------------------------------------------------------- graphs


def find_cycles(adj: Dict) -> List[List]:
    """Elementary cycles in a directed graph given as ``{node: [succ, ...]}``,
    deduplicated by node set. Shared by the static lock-order checker and the
    runtime sanitizer so the two halves can never diverge on what counts as a
    cycle. Self-loops are the caller's concern (both graphs exclude them at
    edge insertion)."""
    out: List[List] = []
    seen: set = set()

    def dfs(start, node, path, visiting):
        for nxt in adj.get(node, ()):
            if nxt == start:
                key = frozenset(path)
                if key not in seen:
                    seen.add(key)
                    out.append(list(path))
            elif nxt not in visiting and nxt in adj:
                visiting.add(nxt)
                dfs(start, nxt, path + [nxt], visiting)
                visiting.discard(nxt)

    for start in sorted(adj):
        dfs(start, start, [start], {start})
    return out


# ---------------------------------------------------------------------- runner


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    # Deduped by absolute path: overlapping arguments (`ray_tpu
    # ray_tpu_torch/serve`) must not scan a file twice — duplicate findings
    # would shift occurrence ordinals and break baseline fingerprints.
    seen: set = set()

    def emit(p: str) -> Iterable[str]:
        ap = os.path.abspath(p)
        if ap not in seen:
            seen.add(ap)
            yield p

    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield from emit(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", ".ray_tpu")
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield from emit(os.path.join(dirpath, fn))


def iter_modules(
    paths: Sequence[str],
    root: Optional[str] = None,
    errors: Optional[List[str]] = None,
) -> Iterable[ModuleContext]:
    """Yield a ModuleContext per parseable .py file under ``paths``
    (deduped); unreadable/unparseable files are appended to ``errors``.
    The single read/parse/relpath loop shared by ``analyze_paths`` and
    ``checkers.static_lock_graph``."""
    root = os.path.abspath(root or os.getcwd())
    for path in iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            if errors is not None:
                errors.append(f"{path}: {e}")
            continue
        relpath = os.path.relpath(os.path.abspath(path), root)
        yield ModuleContext(path, relpath, source, tree)


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    suppressed: int
    errors: List[str]
    files_scanned: int


def analyze_paths(
    paths: Sequence[str],
    root: Optional[str] = None,
    select: Optional[Sequence[str]] = None,
) -> AnalysisResult:
    """Run every registered checker (or the ``select`` subset) over the
    .py files under ``paths``. Pragma-suppressed findings are dropped."""
    # Import for side effect: populates CHECKERS.
    from ray_tpu_torch.analysis import checkers as _checkers  # noqa: F401

    names = list(select) if select else sorted(CHECKERS)
    unknown = [n for n in names if n not in CHECKERS]
    if unknown:
        raise ValueError(f"unknown checks: {unknown}; have {sorted(CHECKERS)}")
    instances = [CHECKERS[n]() for n in names]

    findings: List[Finding] = []
    errors: List[str] = []
    suppressed = 0
    files_scanned = 0
    # relpath -> Pragmas, so finalize() findings get pragma treatment too
    pragma_tables: Dict[str, Pragmas] = {}

    for ctx in iter_modules(paths, root=root, errors=errors):
        files_scanned += 1
        pragmas = Pragmas(ctx.source)
        pragma_tables[ctx.relpath] = pragmas
        for chk in instances:
            for f_ in chk.check_module(ctx):
                if pragmas.suppressed(f_):
                    suppressed += 1
                else:
                    findings.append(f_)

    for chk in instances:
        for f_ in chk.finalize():
            table = pragma_tables.get(f_.path)
            if table is not None and table.suppressed(f_):
                suppressed += 1
            else:
                findings.append(f_)

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    counts: Dict[Tuple[str, str, str], int] = {}
    for f_ in findings:
        key = (f_.path, f_.check, f_.line_text)
        f_.occurrence = counts.get(key, 0)
        counts[key] = f_.occurrence + 1
    return AnalysisResult(
        findings=findings,
        suppressed=suppressed,
        errors=errors,
        files_scanned=files_scanned,
    )


# -------------------------------------------------------------------- baseline


def load_baseline(path: str) -> Dict[str, Dict]:
    """Baseline file: {"findings": {fingerprint: example entry}}. Missing
    file means empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return dict(data.get("findings", {}))


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = {f.fingerprint(): f.to_dict() for f in findings}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(
            {
                "comment": (
                    "ray_tpu_torch.analysis ratchet baseline: grandfathered "
                    "findings by content fingerprint. Entries may only be "
                    "removed (fixed), never added by hand — regenerate with "
                    "python -m ray_tpu_torch.analysis <paths> --update-baseline."
                ),
                "findings": entries,
            },
            f,
            indent=2,
            sort_keys=True,
        )
        f.write("\n")


def split_by_baseline(
    findings: Sequence[Finding], baseline: Dict[str, Dict]
) -> Tuple[List[Finding], List[Finding]]:
    """Partition findings into (new, grandfathered)."""
    new: List[Finding] = []
    known: List[Finding] = []
    for f in findings:
        (known if f.fingerprint() in baseline else new).append(f)
    return new, known
