"""Linear and LayerNorm layers that compute in their parameter dtype.

Like flax's ``nn.Dense(dtype=...)``, they cast the input to the layer's
dtype first, so an f32 positional encoding added to a bf16 stream feeds a
bf16 layer without a dtype error. State-dict keys are those of
``torch.nn.Linear`` / ``torch.nn.LayerNorm``.
"""

from __future__ import annotations

import torch.nn as nn


class Linear(nn.Linear):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))
