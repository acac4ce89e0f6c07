"""Placement group user API.

Reference: python/ray/util/placement_group.py — placement_group(bundles,
strategy), PlacementGroup.ready()/wait(), remove_placement_group; backed by
the GCS PG manager (gcs_placement_group_manager.cc). Strategies:
STRICT_PACK / PACK / SPREAD / STRICT_SPREAD (bundle_scheduling_policy.cc),
implemented in ray_tpu_torch/sched/bundles.py.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.task_spec import new_id

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the PG is placed (reference: pg.ready() returns an
        ObjectRef; here it blocks directly — await-able plumbing comes with
        the async API)."""
        from ray_tpu_torch.core import api

        rt = api._get_runtime()
        deadline = time.time() + (timeout if timeout is not None else 3600.0)
        while time.time() < deadline:
            st = rt.get_placement_group(self.id)
            if st and st.get("state") == "CREATED":
                return True
            if st is None:
                return False
            time.sleep(0.05)
        return False

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self.bundles)

    def __repr__(self):
        return f"PlacementGroup({self.id}, {self.strategy}, {len(self.bundles)} bundles)"


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    from ray_tpu_torch.core import api

    rt = api._get_runtime()
    pg_id = new_id("pg")
    rt.create_placement_group(pg_id, bundles, strategy, name)
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch.core import api

    api._get_runtime().remove_placement_group(pg.id)


def get_placement_group_state(pg: PlacementGroup) -> Optional[dict]:
    from ray_tpu_torch.core import api

    return api._get_runtime().get_placement_group(pg.id)
