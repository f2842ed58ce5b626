"""Pre-LN transformer building blocks (counterpart of
``clip_embeds_tpu/models/layers.py``).

Module and parameter names follow open_clip
(``open_clip/transformer.py`` ResidualAttentionBlock), so an open_clip state
dict loads with ``load_state_dict``: ``attn.in_proj_weight`` is [3d, d]
(q, k, v stacked), ``nn.Linear`` weights are [out, in]. Activations are
[B, N, d]. The projections are plain ``nn.Linear``, or with ``quant``
('dynamic' / 'static') int8 :class:`~.quant.QuantLinear` (the packed
``in_proj`` becomes one [3d, d] QuantLinear, as the JAX ``in_proj``);
attention goes through ``ops.attention.dot_product_attention`` (the flash
kernel for bf16 on the card, plain PyTorch otherwise).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .quant import Quant, linear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def get_act(quick: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    return quick_gelu if quick else exact_gelu


class MultiHeadAttention(nn.Module):
    """Packed-QKV multi-head attention (torch nn.MultiheadAttention names)."""

    def __init__(self, width: int, heads: int, quant: Quant = False):
        super().__init__()
        self.width, self.heads = width, heads
        if quant:
            self.in_proj = linear(quant, width, 3 * width)
        else:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
            self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = linear(quant, width, width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, n, _ = x.shape
        hd = self.width // self.heads
        if hasattr(self, "in_proj"):
            qkv = self.in_proj(x)
        else:
            qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        # [B, n, 3, H, hd] -> three [B, H, n, hd] views of the packed buffer
        q, k, v = qkv.view(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        out = dot_product_attention(q, k, v, causal=causal)
        out = out.transpose(1, 2).reshape(b, n, self.width)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, width: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False, quant: Quant = False):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.c_fc = linear(quant, width, hidden)
        self.c_proj = linear(quant, hidden, width)
        self.act = get_act(quick_gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False, quant: Quant = False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, quant)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = MLP(width, mlp_ratio, quick_gelu, quant)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal=causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """Stack of residual blocks. ``num_blocks`` runs only the first k blocks
    (the LLaVA hidden_states[-2] tap)."""

    def __init__(self, width: int, layers: int, heads: int,
                 mlp_ratio: float = 4.0, quick_gelu: bool = False,
                 quant: Quant = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, quick_gelu, quant)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, causal: bool = False,
                num_blocks: Optional[int] = None) -> torch.Tensor:
        n = len(self.resblocks) if num_blocks is None else num_blocks
        for block in self.resblocks[:n]:
            x = block(x, causal=causal)
        return x
