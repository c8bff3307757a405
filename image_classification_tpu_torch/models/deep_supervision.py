"""Deep supervision wrapper, port of
``image_classification_tpu/models/deep_supervision.py``: each of the
backbone's taps (ConvNeXt's and EfficientNet's last three stage outputs,
ViT's token sequences after its tap blocks) gets a pool -> Linear head,
computed in f32 on the f32 pooled features: a global average pool of a
(B, H, W, C) map, the mean over tokens of a (B, N, D) sequence, each summed
in f32 and rounded to the features' dtype (``jnp.mean``). Forward returns
``(logits, aux0, aux1, ...)``.
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
            pooled = (global_avg_pool(f) if f.dim() == 4
                      else f.float().mean(dim=1).to(f.dtype)).float()
            outs.append(torch.matmul(pooled, head.weight.float().t())
                        + head.bias.float())
        return tuple(outs)
