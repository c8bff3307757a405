"""Deep supervision wrapper, port of
``image_classification_tpu/models/deep_supervision.py``: the backbone's
stage 1..3 outputs each get a global-average-pool -> Linear head, computed in
f32 on the f32 pooled features. Forward returns ``(logits, aux0, aux1, aux2)``.
"""

from __future__ import annotations

import torch
from torch import nn

from image_classification_tpu_torch.models.layers import global_avg_pool


class DeepSupervisionModel(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int = 44):
        super().__init__()
        self.backbone = backbone
        for i, dim in enumerate(backbone.feature_dims):
            self.add_module(f"aux_head{i}", nn.Linear(dim, num_classes))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        logits, feats = self.backbone(x, return_features=True)
        outs = [logits]
        for i, f in enumerate(feats):
            head = getattr(self, f"aux_head{i}")
            pooled = global_avg_pool(f).float()
            outs.append(torch.matmul(pooled, head.weight.float().t())
                        + head.bias.float())
        return tuple(outs)
