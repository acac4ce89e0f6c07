from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, NodeTypeConfig
from ray_tpu_torch.autoscaler.provider import FakeNodeProvider, NodeProvider

__all__ = ["Autoscaler", "NodeTypeConfig", "NodeProvider", "FakeNodeProvider"]
