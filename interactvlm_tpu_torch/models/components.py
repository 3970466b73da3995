"""InteractVLM heads around the backbones (port of
``interactvlm_tpu/models/components.py`` for the ``Gen`` / ``simple`` path).

``TextHiddenFcs`` keeps the reference's module layout
(``text_hidden_fcs.0.0`` / ``.0.2``: a list holding Linear-ReLU-Linear-
Dropout), so the merged InteractVLM checkpoint loads by key.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from interactvlm_tpu_torch.models.layers import Linear


class TextHiddenFcs(nn.ModuleList):
    """[SEG] hidden-state projection hidden_size -> out_dim
    (reference InteractVLM.py:103-109)."""

    def __init__(self, hidden_size: int, out_dim: int, dtype, device):
        kw = dict(dtype=dtype, device=device)
        super().__init__([nn.Sequential(
            Linear(hidden_size, hidden_size, **kw), nn.ReLU(),
            Linear(hidden_size, out_dim, **kw), nn.Dropout(0.0),
        )])

    def forward(self, x):
        return self[0](x)


class CamPoseEncoder(nn.Module):
    """'simple': Linear + ReLU on the 5-dof cam params, ADDED to each view's
    prompt embedding (reference components.py:491-508)."""

    def __init__(self, output_dim: int, dtype, device):
        super().__init__()
        self.linear1 = Linear(5, output_dim, dtype=dtype, device=device)

    def forward(self, cam_params):
        return F.relu(self.linear1(cam_params))
