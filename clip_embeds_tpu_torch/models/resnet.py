"""ModifiedResNet vision tower, the CLIP RN50 family (counterpart of
``clip_embeds_tpu/models/resnet.py``).

A 3-conv stem with an average pool, antialiased strided bottlenecks (an
average pool before the stride-2 conv) and the QKV attention pool, whose
query is the mean token: only the query's output is used, so the
single-query form JAX computes is the same function (open_clip's
``modified_resnet.py`` AttentionPool2d). The pool's attention is plain, as
in JAX. BatchNorms are frozen: they always normalise with their running
statistics (JAX's ``FrozenBatchNorm``; open_clip only runs these towers
frozen). Module names are open_clip's (``visual.conv1``, ``visual.bn1``,
``visual.layer1.0.*``, ``visual.attnpool.*``), so an open_clip or OpenAI RN
state dict loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .timm_vit import merge_heads, plain_attention


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always uses its running statistics (train mode
    included), with open_clip's parameter and buffer names."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps) \
            * self.weight.float()
        shift = self.bias.float() - self.running_mean.float() * inv
        return x * inv.to(x.dtype)[:, None, None] \
            + shift.to(x.dtype)[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=(k - 1) // 2, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * self.expansion, 1)
        self.bn3 = FrozenBatchNorm2d(planes * self.expansion)
        self.stride = stride
        if stride > 1 or inplanes != planes * self.expansion:
            self.downsample = nn.Sequential()
            self.downsample.add_module(
                "0", _conv(inplanes, planes * self.expansion, 1))
            self.downsample.add_module(
                "1", FrozenBatchNorm2d(planes * self.expansion))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample(identity)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial: int, embed_dim: int, heads: int,
                 output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial * spacial + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.heads = heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> [B, output_dim] by mean-query attention."""
        tokens = x.flatten(2).transpose(1, 2)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        q = self.q_proj(tokens[:, :1])
        k, v = self.k_proj(tokens), self.v_proj(tokens)
        b, n, d = k.shape
        q, k, v = (t.view(b, -1, self.heads, d // self.heads).transpose(1, 2)
                   for t in (q, k, v))
        return self.c_proj(merge_heads(plain_attention(q, k, v))[:, 0])


class ModifiedResNet(nn.Module):
    """[B, S, S, 3] -> (pooled [B, output_dim], final grid tokens)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 image_size: int = 224, width: int = 64):
        super().__init__()
        self.conv1 = _conv(3, width // 2, 3, 2)
        self.bn1 = FrozenBatchNorm2d(width // 2)
        self.conv2 = _conv(width // 2, width // 2, 3)
        self.bn2 = FrozenBatchNorm2d(width // 2)
        self.conv3 = _conv(width // 2, width, 3)
        self.bn3 = FrozenBatchNorm2d(width)
        inplanes, planes = width, width
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            mods = []
            for i in range(blocks):
                mods.append(Bottleneck(inplanes, planes,
                                       stride if i == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))
            planes *= 2
        self.n_stages = len(layers)
        self.attnpool = AttentionPool2d(image_size // 32, width * 32, heads,
                                        output_dim)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = images.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        pooled = self.attnpool(x)
        return pooled, x.flatten(2).transpose(1, 2)
