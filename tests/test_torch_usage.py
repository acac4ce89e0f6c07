"""ray_tpu_torch's local usage records against ray_tpu's: the same fields
in the record, the port's own version and session directory, and the
opt-out through RAY_TPU_usage_stats_enabled (a live environment read) and
through the config key."""

import json

import pytest

from ray_tpu.core import config as ref_config_mod
from ray_tpu.util import usage as ref_usage
from ray_tpu_torch import _version
from ray_tpu_torch.core import config as config_mod
from ray_tpu_torch.util import usage


@pytest.fixture
def roots(tmp_path, monkeypatch):
    monkeypatch.delenv("RAY_TPU_usage_stats_enabled", raising=False)
    port, ref = tmp_path / "port", tmp_path / "ref"
    monkeypatch.setitem(config_mod.GLOBAL_CONFIG._values, "session_dir_root", str(port))
    monkeypatch.setitem(ref_config_mod.GLOBAL_CONFIG._values, "session_dir_root", str(ref))
    return port, ref


def _records(root):
    f = root / "usage" / "usage.jsonl"
    return [json.loads(line) for line in f.read_text().splitlines()] if f.exists() else []


def test_record_fields_equal_ray_tpu(roots):
    port, ref = roots
    for mod in (usage, ref_usage):
        assert mod.usage_stats_enabled()
        mod.record_event("cluster_up", nodes=3, detail="x")
    (p,), (r,) = _records(port), _records(ref)
    assert sorted(p) == sorted(r) == ["detail", "event", "nodes", "pid", "ts", "version"]
    assert {k: p[k] for k in ("event", "nodes", "detail", "pid")} == \
        {k: r[k] for k in ("event", "nodes", "detail", "pid")}
    assert p["version"] == _version.__version__


@pytest.mark.parametrize("value,enabled", [("false", False), ("0", False), ("off", False),
                                           ("no", False), ("true", True), ("1", True)])
def test_opt_out_by_environment_equals_ray_tpu(roots, monkeypatch, value, enabled):
    port, ref = roots
    monkeypatch.setenv("RAY_TPU_usage_stats_enabled", value)
    for mod in (usage, ref_usage):
        assert mod.usage_stats_enabled() is enabled
        mod.record_event("maybe")
    assert len(_records(port)) == len(_records(ref)) == int(enabled)


def test_opt_out_by_config_key(roots, monkeypatch):
    port, _ = roots
    monkeypatch.setitem(config_mod.GLOBAL_CONFIG._values, "usage_stats_enabled", False)
    assert not usage.usage_stats_enabled()
    usage.record_event("should_not_appear")
    assert _records(port) == []


def test_record_never_raises_on_an_unwritable_root(roots, monkeypatch, tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    for mod, cfg in ((usage, config_mod), (ref_usage, ref_config_mod)):
        monkeypatch.setitem(cfg.GLOBAL_CONFIG._values, "session_dir_root",
                            str(blocker / "below"))
        with pytest.raises(OSError):
            mod._usage_path()
        assert mod.record_event("x") is None
