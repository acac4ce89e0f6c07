"""Dashboard head: HTTP/JSON observability endpoints.

Reference: python/ray/dashboard/head.py + modules/state/state_head.py —
the REST surface the dashboard UI and `ray list` tooling consume. The
React frontend is deliberately out of scope (SURVEY §7); the API head is
the component: every state view the CLI offers, served as JSON over HTTP.
"""

from ray_tpu_torch.dashboard.head import DashboardHead

__all__ = ["DashboardHead"]
