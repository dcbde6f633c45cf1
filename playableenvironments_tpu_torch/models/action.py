"""Per-dynamic-object animation model, as far as the play loop needs it.

Port of playableenvironments_tpu/models/action.py::ObjectAnimationModel's
`dynamics_network`. The action network, centroid estimation and the fused
rollout come with the phase-3 slice.
"""

from __future__ import annotations

from torch import nn

from playableenvironments_tpu_torch.config import AnimationModelConfig
from playableenvironments_tpu_torch.models.dynamics import DynamicsNetwork


class ObjectAnimationModel(nn.Module):
    """Holds `dynamics_network` for one dynamic object model."""

    def __init__(self, cfg: AnimationModelConfig, bounding_box, device=None):
        super().__init__()
        self.cfg = cfg
        self.dynamics_network = DynamicsNetwork(cfg, bounding_box, device=device)
