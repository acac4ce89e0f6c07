"""User-defined + system metrics: Counter/Gauge/Histogram with Prometheus
text exposition and a cluster-wide delta-export pipeline.

Reference: python/ray/util/metrics.py (Counter, Gauge, Histogram flowing
through the per-node metrics agent to Prometheus; C++ registry in
src/ray/stats/metric_defs.cc). Here metrics register in an in-process
registry; ``export_prometheus()`` renders the standard text format and the
cluster dashboard serves it (reference: dashboard/modules/metrics).

Cluster pipeline (ray_tpu.obs): every process keeps its own registry and
periodically exports a **delta snapshot** (``snapshot_delta()``) of what
changed since its last export. Worker processes push deltas to their node
daemon (``metrics_push``), daemons fold worker deltas into their own and
ride the result on the existing GCS heartbeat (``"metrics"`` payload key),
and the GCS folds everything into a :class:`MetricsAggregator` served at
``/metrics`` (Prometheus text) and ``/api/metrics`` (JSON) on the
dashboard head and by ``ray_tpu metrics``. Deltas make the pipeline
restart-safe: a process that reconnects simply resumes sending increments
and nothing is double-counted.

Heartbeat delta-export format (the ``"metrics"`` heartbeat payload value,
also what ``metrics_push`` carries in ``"delta"``)::

    {"<metric name>": {
        "kind": "counter" | "gauge" | "histogram",
        "desc": "<help text>",
        "boundaries": [b0, b1, ...],      # histogram only
        "series": {
            ((tag, value), ...):          # sorted tag-pair tuple key
                float                     # counter: increment since the
                                          #   last export (>= 0)
                                          # gauge: current absolute value
                ,
            ((tag, value), ...):          # histogram: deltas since the
                [counts, sum, total]      #   last export (counts has
                                          #   len(boundaries)+1 entries)
        }}}

Counter/histogram deltas PARTITION the underlying totals: with several
exporters in one process (the embedded test topology shares one registry
between the GCS and in-process daemons) each increment is exported exactly
once by whichever exporter snapshots first, so cluster-wide sums stay
exact even though attribution between same-process sources is arbitrary.
Gauges are absolute, keyed per source in the aggregator (a dead node's
gauges are dropped; its counters remain, already folded into the totals),
and rendered last-writer-wins per series — every exporter ships ALL
current gauge series from its registry, so summing across sources would
multiply shared-registry series by the exporter count. Series that need
per-node attribution carry an explicit ``node`` tag (e.g. the daemon
rpc-handler histograms and store/queue gauges).

``ENABLED`` is the single hot-path guard (config ``metrics_enabled`` /
env ``RAY_TPU_metrics_enabled``); instrumented sites check the module
global once and skip all bookkeeping when off. If the env var
``RAY_TPU_METRICS_DUMP`` names a file, the process writes a final
Prometheus snapshot there at exit (used by ``lint_gate --tier1`` and the
soak scripts so runs are diffable).
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_right
from typing import Any, Dict, List, Optional, Sequence, Tuple

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, "Metric"] = {}

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Module-global on/off switch consulted by every instrumented hot path
# (one global load; same pattern as rpc.CHAOS/rpc.TRACE). Initialized from
# config so RAY_TPU_metrics_enabled=0 disables collection process-wide.
try:
    from ray_tpu_torch.core import config as _config

    ENABLED = bool(_config.GLOBAL_CONFIG.metrics_enabled)
except Exception:  # pragma: no cover - bootstrap ordering safety
    ENABLED = True


def set_enabled(on: bool) -> None:
    global ENABLED
    ENABLED = bool(on)


def _key(tags: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((tags or {}).items()))


def _rebuild_metric(cls, name, description, tag_keys, ctor_kwargs=None,
                    default_tags=None):
    """Unpickle hook (see Metric.__reduce__): resolve to the process's
    existing registry entry — module import normally created it already —
    and only construct a fresh one for a genuinely unknown name (carrying
    the subclass-specific config, e.g. a Histogram's boundaries, so the
    fallback doesn't silently bucket into defaults)."""
    with _REGISTRY_LOCK:
        existing = _REGISTRY.get(name)
    if existing is not None:
        return existing
    m = cls(name, description, tag_keys=tag_keys, **(ctor_kwargs or {}))
    if default_tags:
        m.set_default_tags(default_tags)
    return m


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _REGISTRY_LOCK:
            _REGISTRY[name] = self

    def __reduce__(self):
        # Metrics are process-global named singletons holding a lock — a
        # by-value pickle is both impossible (the lock) and wrong (the
        # target process must feed ITS registry). Reconstruct by
        # (type, name): cloudpickle hits this when a class whose methods
        # reference a module-level metric is shipped by value (e.g. the
        # serve controller closing over the replica class in cluster mode).
        return (_rebuild_metric,
                (type(self), self.name, self.description, self.tag_keys,
                 self._ctor_kwargs(), dict(self._default_tags) or None))

    def _ctor_kwargs(self) -> dict:
        """Subclass-specific constructor config to survive the pickle
        round trip when the registry misses (Histogram: boundaries)."""
        return {}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(self._default_tags)
        out.update(tags or {})
        return out

    def _render_tags(self, key: Tuple) -> str:
        if not key:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in key)
        return "{" + inner + "}"

    def _delta(self) -> Dict[Tuple, Any]:
        """Per-series change since the last ``_delta`` call (see the
        module docstring for the shape); empty dict = nothing new."""
        return {}

    def series_key(self, tags: Optional[Dict[str, str]] = None) -> Tuple:
        """Precompute a series key for the ``*_k`` fast-path variants:
        hot instrumentation sites (per-rpc, per-frame) cache the key once
        per tag combination instead of building + sorting a tag dict on
        every observation."""
        return _key(self._tags(tags))


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}
        self._exported: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = _key(self._tags(tags))
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def inc_k(self, key: Tuple, value: float = 1.0):
        """Fast-path inc with a precomputed :meth:`series_key`."""
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def _delta(self) -> Dict[Tuple, float]:
        out: Dict[Tuple, float] = {}
        with self._lock:
            for k, v in self._values.items():
                d = v - self._exported.get(k, 0.0)
                if d:
                    out[k] = d
                    self._exported[k] = v
        return out

    def _expose(self) -> List[str]:
        with self._lock:
            return [
                f"{self.name}{self._render_tags(k)} {v}"
                for k, v in sorted(self._values.items())
            ]


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[_key(self._tags(tags))] = float(value)

    def set_k(self, key: Tuple, value: float):
        """Fast-path set with a precomputed :meth:`series_key`."""
        with self._lock:
            self._values[key] = float(value)

    def inc(self, value: float = 1.0, tags=None):
        k = _key(self._tags(tags))
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def dec(self, value: float = 1.0, tags=None):
        self.inc(-value, tags)

    def _delta(self) -> Dict[Tuple, float]:
        # gauges export their current absolute values (last-wins per
        # source at the aggregator), not differences
        with self._lock:
            return dict(self._values)

    def _expose(self) -> List[str]:
        with self._lock:
            return [
                f"{self.name}{self._render_tags(k)} {v}"
                for k, v in sorted(self._values.items())
            ]


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries: Sequence[float] = DEFAULT_BUCKETS,
                 tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}
        self._exported: Dict[Tuple, list] = {}  # key -> [counts, sum, total]

    def _ctor_kwargs(self) -> dict:
        return {"boundaries": tuple(self.boundaries)}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self.observe_k(_key(self._tags(tags)), value)

    def observe_k(self, key: Tuple, value: float):
        """Fast-path observe with a precomputed :meth:`series_key`."""
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[bisect_right(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def _delta(self) -> Dict[Tuple, list]:
        out: Dict[Tuple, list] = {}
        with self._lock:
            for k, counts in self._counts.items():
                prev = self._exported.get(k)
                if prev is None:
                    prev = [[0] * len(counts), 0.0, 0]
                dtotal = self._totals[k] - prev[2]
                if not dtotal:
                    continue
                out[k] = [
                    [c - p for c, p in zip(counts, prev[0])],
                    self._sums[k] - prev[1],
                    dtotal,
                ]
                self._exported[k] = [list(counts), self._sums[k],
                                     self._totals[k]]
        return out

    def _expose(self) -> List[str]:
        out = []
        with self._lock:
            for k, counts in sorted(self._counts.items()):
                cum = 0
                for b, c in zip(self.boundaries, counts):
                    cum += c
                    tags = dict(k)
                    tags["le"] = repr(b)
                    out.append(
                        f"{self.name}_bucket{self._render_tags(_key(tags))} {cum}"
                    )
                tags = dict(k)
                tags["le"] = "+Inf"
                out.append(
                    f"{self.name}_bucket{self._render_tags(_key(tags))} {self._totals[k]}"
                )
                out.append(f"{self.name}_sum{self._render_tags(k)} {self._sums[k]}")
                out.append(f"{self.name}_count{self._render_tags(k)} {self._totals[k]}")
        return out


def export_prometheus() -> str:
    """Render every registered metric in Prometheus text format."""
    lines: List[str] = []
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    for m in metrics:
        if m.description:
            lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        lines.extend(m._expose())
    return "\n".join(lines) + "\n"


def clear_registry():
    with _REGISTRY_LOCK:
        _REGISTRY.clear()


# ------------------------------------------------------- delta pipeline


def snapshot_delta() -> Dict[str, dict]:
    """One export tick: every registered metric's change since the last
    call (module-docstring format). Stateful — increments are handed out
    exactly once across all callers in this process."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    out: Dict[str, dict] = {}
    for m in metrics:
        series = m._delta()
        if not series:
            continue
        ent: Dict[str, Any] = {
            "kind": m.kind, "desc": m.description, "series": series,
        }
        if m.kind == "histogram":
            ent["boundaries"] = list(m.boundaries)
        out[m.name] = ent
    return out


def merge_deltas(dst: Dict[str, dict], src: Dict[str, dict]) -> Dict[str, dict]:
    """Fold delta snapshot ``src`` into ``dst`` in place (the daemon uses
    this to combine its workers' pushes with its own tick). Counters and
    histogram deltas add; gauges last-write-wins per series."""
    for name, ent in src.items():
        d = dst.get(name)
        if d is None:
            dst[name] = {
                "kind": ent["kind"], "desc": ent.get("desc", ""),
                "series": dict(ent["series"]),
                **({"boundaries": list(ent["boundaries"])}
                   if "boundaries" in ent else {}),
            }
            continue
        ds = d["series"]
        for k, v in ent["series"].items():
            if ent["kind"] == "counter":
                ds[k] = ds.get(k, 0.0) + v
            elif ent["kind"] == "gauge":
                ds[k] = v
            else:  # histogram [counts, sum, total]
                prev = ds.get(k)
                if prev is None:
                    ds[k] = [list(v[0]), v[1], v[2]]
                else:
                    prev[0] = [a + b for a, b in zip(prev[0], v[0])]
                    prev[1] += v[1]
                    prev[2] += v[2]
    return dst


class MetricsAggregator:
    """Cluster-wide metric state, fed by per-source delta snapshots.

    Lives in the GCS (reference: the dashboard's metrics agent + Prometheus
    scrape combo collapsed into one process). Counters and histograms fold
    deltas into cumulative totals keyed by (name, tags) — restart-safe by
    construction. Gauges are stored per source (so :meth:`drop_source` can
    retire a dead node's last-reported values) and rendered
    **last-writer-wins per series**: every exporter ships ALL current
    gauge series from its registry, so in a shared-registry topology
    (embedded tests: GCS + in-process daemons) the same series arrives
    under several sources — summing would multiply it by the exporter
    count. Distinct quantities that must not collapse carry
    distinguishing tags (the daemon gauges carry ``node``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ingest_seq = 0  # orders gauge writes across sources
        # name -> {"kind", "desc", "boundaries"?, "counters": {key: v},
        #          "hist": {key: [counts, sum, total]},
        #          "gauges": {source: {key: (ingest_seq, v)}}}
        self._metrics: Dict[str, dict] = {}

    def ingest(self, source: str, delta: Dict[str, dict]) -> None:
        with self._lock:
            self._ingest_seq += 1
            seq = self._ingest_seq
            for name, ent in (delta or {}).items():
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = {
                        "kind": ent["kind"], "desc": ent.get("desc", ""),
                        "counters": {}, "hist": {}, "gauges": {},
                    }
                    if "boundaries" in ent:
                        m["boundaries"] = list(ent["boundaries"])
                kind = ent["kind"]
                for k, v in ent["series"].items():
                    k = tuple(tuple(p) for p in k)  # survive json round-trips
                    if kind == "counter":
                        m["counters"][k] = m["counters"].get(k, 0.0) + v
                    elif kind == "gauge":
                        m["gauges"].setdefault(source, {})[k] = (seq, v)
                    else:
                        prev = m["hist"].get(k)
                        if prev is None:
                            m["hist"][k] = [list(v[0]), float(v[1]), int(v[2])]
                        else:
                            prev[0] = [a + b for a, b in zip(prev[0], v[0])]
                            prev[1] += v[1]
                            prev[2] += v[2]

    def drop_source(self, source: str) -> None:
        """A node died: retire its gauge series (its counters/histograms
        stay — they are already part of the cumulative totals)."""
        with self._lock:
            for m in self._metrics.values():
                m["gauges"].pop(source, None)

    # ------------------------------------------------------- rendering

    def _gauge_values(self, m: dict) -> Dict[Tuple, float]:
        """Last-writer-wins per series across surviving sources (see the
        class docstring for why sums would be wrong)."""
        best: Dict[Tuple, tuple] = {}
        for per_src in m["gauges"].values():
            for k, (seq, v) in per_src.items():
                cur = best.get(k)
                if cur is None or seq > cur[0]:
                    best[k] = (seq, v)
        return {k: v for k, (_seq, v) in best.items()}

    @staticmethod
    def _render_tags(key: Tuple, extra: Optional[Dict[str, str]] = None) -> str:
        tags = dict(key)
        tags.update(extra or {})
        if not tags:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
        return "{" + inner + "}"

    def render_prometheus(self) -> str:
        lines: List[str] = []
        with self._lock:
            items = sorted(self._metrics.items())
            for name, m in items:
                if m["desc"]:
                    lines.append(f"# HELP {name} {m['desc']}")
                lines.append(f"# TYPE {name} {m['kind']}")
                if m["kind"] == "counter":
                    for k, v in sorted(m["counters"].items()):
                        lines.append(f"{name}{self._render_tags(k)} {v}")
                elif m["kind"] == "gauge":
                    for k, v in sorted(self._gauge_values(m).items()):
                        lines.append(f"{name}{self._render_tags(k)} {v}")
                else:
                    bounds = m.get("boundaries", [])
                    for k, (counts, hsum, total) in sorted(m["hist"].items()):
                        cum = 0
                        for b, c in zip(bounds, counts):
                            cum += c
                            lines.append(
                                f"{name}_bucket"
                                f"{self._render_tags(k, {'le': repr(b)})} {cum}"
                            )
                        lines.append(
                            f"{name}_bucket"
                            f"{self._render_tags(k, {'le': '+Inf'})} {total}"
                        )
                        lines.append(f"{name}_sum{self._render_tags(k)} {hsum}")
                        lines.append(f"{name}_count{self._render_tags(k)} {total}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> Dict[str, dict]:
        """JSON-safe aggregate view (the ``/api/metrics`` body and what
        ``ray_tpu metrics --top`` ranks)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for name, m in self._metrics.items():
                ent: Dict[str, Any] = {"kind": m["kind"], "desc": m["desc"],
                                       "series": []}
                if m["kind"] == "counter":
                    for k, v in sorted(m["counters"].items()):
                        ent["series"].append({"tags": dict(k), "value": v})
                elif m["kind"] == "gauge":
                    for k, v in sorted(self._gauge_values(m).items()):
                        ent["series"].append({"tags": dict(k), "value": v})
                else:
                    ent["boundaries"] = m.get("boundaries", [])
                    for k, (counts, hsum, total) in sorted(m["hist"].items()):
                        ent["series"].append({
                            "tags": dict(k), "counts": list(counts),
                            "sum": hsum, "count": total,
                        })
                out[name] = ent
        return out


# --------------------------------------------------- exit-snapshot hook

if os.environ.get("RAY_TPU_METRICS_DUMP"):  # pragma: no cover - env-driven
    def _dump_at_exit(path=os.environ["RAY_TPU_METRICS_DUMP"]):
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write(export_prometheus())
        except OSError:
            pass

    import atexit

    atexit.register(_dump_at_exit)
