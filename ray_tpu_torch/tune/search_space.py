"""Search-space primitives.

Reference: python/ray/tune/search/sample.py (Domain, Float, Integer,
Categorical, grid_search) — the ``tune.uniform/loguniform/choice/...``
surface.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: Optional[float] = None):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return float(v)


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            return int(
                math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
            )
        return int(rng.integers(self.lower, self.upper))


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(0, len(self.categories)))]


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn()


class GridSearch:
    """Marker resolved by the variant generator, not sampled."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


# ------------------------------------------------------------ public surface

def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> Dict[str, Any]:
    # reference shape: {"grid_search": [...]} dict marker
    return {"grid_search": list(values)}


def _is_grid(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _expand_grids(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cross-product over every grid_search, recursing into nested dicts.
    Domain leaves are left unsampled."""
    expanded: List[Dict[str, Any]] = [{}]
    for k, v in space.items():
        if _is_grid(v):
            branches = v["grid_search"]
        elif isinstance(v, dict):
            branches = _expand_grids(v)  # nested grids cross-multiply too
        else:
            branches = [v]
        expanded = [{**e, k: b} for e in expanded for b in branches]
    return expanded


def _sample_tree(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    out = {}
    for k, v in space.items():
        if isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, dict):
            out[k] = _sample_tree(v, rng)
        else:
            out[k] = v
    return out


def resolve_variants(
    param_space: Dict[str, Any], num_samples: int, seed: Optional[int] = None
) -> List[Dict[str, Any]]:
    """Grid cross-product (incl. nested grids) × num_samples random draws
    (reference: tune/search/basic_variant.py BasicVariantGenerator)."""
    rng = np.random.default_rng(seed)
    grids = _expand_grids(param_space)
    return [_sample_tree(g, rng) for _ in range(num_samples) for g in grids]
