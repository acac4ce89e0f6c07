"""Tiny built-in RL environments (no gym dependency in this image).

Reference: RLlib smoke-tests its algorithms on CartPole
(rllib/tuned_examples/, rllib/env/). The env API mirrors the gymnasium
reset/step contract so user envs drop in: reset() -> (obs, info),
step(a) -> (obs, reward, terminated, truncated, info).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class CartPole:
    """Classic cart-pole balance task, standard physics constants."""

    observation_size = 4
    num_actions = 2

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * 2 * np.pi / 360
    MAX_STEPS = 500

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, np.float32)
        self._steps = 0

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self._steps = 0
        return self._state.copy(), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        temp = (force + pole_ml * theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN
            * (4.0 / 3.0 - self.POLE_MASS * cos_t**2 / total_mass)
        )
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        x = x + self.DT * x_dot
        x_dot = x_dot + self.DT * x_acc
        theta = theta + self.DT * theta_dot
        theta_dot = theta_dot + self.DT * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._steps += 1
        terminated = bool(
            abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT
        )
        truncated = self._steps >= self.MAX_STEPS
        return self._state.copy(), 1.0, terminated, truncated, {}


_ENVS = {"CartPole-v1": CartPole, "CartPole": CartPole}


def register_env(name: str, creator) -> None:
    """User env hook (reference: ray.tune.registry.register_env)."""
    _ENVS[name] = creator


def make_env(spec: Any, seed: Optional[int] = None):
    if callable(spec):
        return spec()
    creator = _ENVS.get(spec)
    if creator is None:
        raise ValueError(f"unknown env {spec!r}; register_env() it first")
    try:
        return creator(seed=seed)
    except TypeError:
        return creator()
