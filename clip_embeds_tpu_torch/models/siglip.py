"""SigLIP (ViT-SO400M family) dual encoder (counterpart of
``clip_embeds_tpu/models/siglip.py``).

* vision: biased patchify, learned pos embed, NO class token, pre-norm
  blocks with tanh-GELU MLPs (hidden_act gelu_pytorch_tanh), post-LN, and a
  MAP head (learned probe cross-attention + LN + residual MLP, pool = probe
  output)
* text: token + pos embeds, the same blocks (bidirectional), final LN,
  pooled = LAST token -> head
* similarity: logit_scale * cos + logit_bias (paired with the sigmoid loss
  of ``losses/siglip.py``)

Submodule names are the flax ones (``blocks.{i}`` for ``blocks_{i}``), so
``core/convert.py`` carries the JAX params and HF ``SiglipModel`` state
dicts across. Linear weights are ``[out, in]``; the patch embedding is a
linear over ``vit.patchify``'s (kh, kw, c) rows; the MAP head keeps
``nn.MultiheadAttention``'s packed ``in_proj_weight`` [3w, w]. A tower
computes in its parameters' dtype. The block attention goes through
``ops.attention.dot_product_attention`` (``attn_impl``: on the card in
bf16 the 729-token image tower takes the flash kernel, the 64-token text
tower plain attention, as the JAX gates route them); the MAP head's one
query always takes plain attention. ``quant`` builds the blocks'
projections as int8 :class:`~.quant.QuantLinear` (the calibration route of
``models/serving.py``); patchify, the embeddings and both heads stay fp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, reference_attention
from .clip import l2_normalize
from .layers import LayerNorm
from .quant import CastLinear, Quant, linear
from .vit import patchify


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    image_size: int = 384
    patch_size: int = 14
    width: int = 1152          # so400m
    layers: int = 27
    heads: int = 16
    intermediate_size: int = 4304
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class SiglipTextConfig:
    vocab_size: int = 32000
    width: int = 1152
    layers: int = 27
    heads: int = 16
    intermediate_size: int = 4304
    max_position_embeddings: int = 64
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    vision: SiglipVisionConfig = dataclasses.field(
        default_factory=SiglipVisionConfig
    )
    text: SiglipTextConfig = dataclasses.field(
        default_factory=SiglipTextConfig
    )


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, w = t.shape
    return t.view(b, n, heads, w // heads).transpose(1, 2)


class SiglipBlock(nn.Module):
    def __init__(self, width: int, heads: int, intermediate_size: int,
                 ln_eps: float, attn_impl: str = "auto",
                 quant: Quant = False):
        super().__init__()
        self.width, self.heads, self.attn_impl = width, heads, attn_impl
        self.ln_1 = LayerNorm(width, eps=ln_eps)
        self.in_proj = linear(quant, width, 3 * width)
        self.out_proj = linear(quant, width, width)
        self.ln_2 = LayerNorm(width, eps=ln_eps)
        self.fc1 = linear(quant, width, intermediate_size)
        self.fc2 = linear(quant, intermediate_size, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.in_proj(self.ln_1(x))
        # [B, n, 3, H, hd] -> three [B, H, n, hd] views of the packed buffer
        q, k, v = qkv.view(b, n, 3, self.heads,
                           self.width // self.heads).permute(2, 0, 3, 1, 4)
        out = dot_product_attention(q, k, v, impl=self.attn_impl)
        x = x + self.out_proj(out.transpose(1, 2).reshape(b, n, self.width))
        return x + self.fc2(tanh_gelu(self.fc1(self.ln_2(x))))


class SiglipMAPHead(nn.Module):
    """Multihead attention pooling: learned probe attends over the tokens,
    then LN + residual MLP; the probe's output is the pooled feature."""

    def __init__(self, width: int, heads: int, intermediate_size: int,
                 ln_eps: float):
        super().__init__()
        self.width, self.heads = width, heads
        self.probe = nn.Parameter(torch.zeros(1, width))
        # torch nn.MultiheadAttention packed in_proj over (q=probe, k=v=x)
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = CastLinear(width, width)
        self.ln = LayerNorm(width, eps=ln_eps)
        self.fc1 = CastLinear(width, intermediate_size)
        self.fc2 = CastLinear(intermediate_size, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        dt = x.dtype
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3)
        q = (self.probe.to(dt) @ wq.t() + bq)[None].expand(b, 1, self.width)
        k = x @ wk.t() + bk
        v = x @ wv.t() + bv
        out = reference_attention(*(_split_heads(t, self.heads)
                                    for t in (q, k, v)))
        out = self.out_proj(out.transpose(1, 2).reshape(b, 1, self.width))
        h = self.fc2(tanh_gelu(self.fc1(self.ln(out))))
        return (out + h)[:, 0]


class SiglipVisionTower(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, attn_impl: str = "auto",
                 quant: Quant = False):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = CastLinear(3 * cfg.patch_size ** 2, cfg.width)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches, cfg.width))
        self.blocks = nn.ModuleList(
            SiglipBlock(cfg.width, cfg.heads, cfg.intermediate_size,
                        cfg.layer_norm_eps, attn_impl, quant)
            for _ in range(cfg.layers))
        self.post_layernorm = LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.head = SiglipMAPHead(cfg.width, cfg.heads,
                                  cfg.intermediate_size, cfg.layer_norm_eps)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> the first block's input [B, N, width]."""
        dt = self.position_embedding.dtype
        x = self.patch_embed(patchify(images.to(dt), self.cfg.patch_size))
        return x + self.position_embedding

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.embed(images)
        for block in self.blocks:
            x = block(x)
        return self.head(self.post_layernorm(x))


class SiglipTextTower(nn.Module):
    def __init__(self, cfg: SiglipTextConfig, attn_impl: str = "auto",
                 quant: Quant = False):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.width))
        self.blocks = nn.ModuleList(
            SiglipBlock(cfg.width, cfg.heads, cfg.intermediate_size,
                        cfg.layer_norm_eps, attn_impl, quant)
            for _ in range(cfg.layers))
        self.final_layer_norm = LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.head = CastLinear(cfg.width, cfg.width)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """int [B, n] -> the first block's input [B, n, width]."""
        x = self.token_embedding.weight[input_ids.long()]
        return x + self.position_embedding[: input_ids.shape[1]]

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(input_ids)
        for block in self.blocks:
            x = block(x)
        # SigLIP pools the LAST token then projects
        return self.head(self.final_layer_norm(x)[:, -1])


class Siglip(nn.Module):
    def __init__(self, cfg: SiglipConfig, attn_impl: str = "auto",
                 quant: Quant = False):
        super().__init__()
        self.cfg = cfg
        self.vision_model = SiglipVisionTower(cfg.vision, attn_impl, quant)
        self.text_model = SiglipTextTower(cfg.text, attn_impl, quant)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(10.0)))
        self.logit_bias = nn.Parameter(torch.tensor(-10.0))

    def encode_image(self, images: torch.Tensor,
                     normalize: bool = True) -> torch.Tensor:
        x = self.vision_model(images)
        return l2_normalize(x) if normalize else x

    def encode_text(self, input_ids: torch.Tensor,
                    normalize: bool = True) -> torch.Tensor:
        x = self.text_model(input_ids)
        return l2_normalize(x) if normalize else x

    def forward(self, images: torch.Tensor,
                input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        img = self.encode_image(images)
        txt = self.encode_text(input_ids)
        scale = self.logit_scale.exp()
        return {
            "image_features": img,
            "text_features": txt,
            "logit_scale": scale,
            "logit_bias": self.logit_bias,
            # logits_per_text (HF convention): t @ i^T * scale + bias
            "logits_per_text": scale * txt @ img.t() + self.logit_bias,
        }


def _init_blocks(blocks, width: int, inter: int, layers: int,
                 g: torch.Generator) -> None:
    """open_clip's residual-block scales: in_proj w^-1/2, the residual
    branches' outputs (out_proj, fc2) also (2 layers)^-1/2, fc1 (2w)^-1/2;
    biases zero."""
    std = width ** -0.5
    out_std = std * (2 * layers) ** -0.5
    for blk in blocks:
        for lin, s in ((blk.in_proj, std), (blk.out_proj, out_std),
                       (blk.fc1, (2 * width) ** -0.5),
                       (blk.fc2, inter ** -0.5 * (2 * layers) ** -0.5)):
            nn.init.normal_(lin.weight, std=s, generator=g)
            nn.init.zeros_(lin.bias)


@torch.no_grad()
def init_siglip(model: Siglip, seed: int = 0) -> Siglip:
    """Seeded random weights in place, drawn on the CPU in fp32 so that one
    seed gives the same weights on any device: normals at open_clip's block
    scales (``_init_blocks``), embeddings and the probe at 0.02, the heads
    at fan_in^-1/2; LayerNorms 1 and 0, the logit scale and bias flax's
    constants. Other values than a JAX ``Siglip.init`` (flax's truncated
    lecun normals from a JAX key)."""
    g = torch.Generator().manual_seed(seed)
    v, t = model.vision_model, model.text_model
    for tower, cfg in ((v, model.cfg.vision), (t, model.cfg.text)):
        nn.init.normal_(tower.position_embedding, std=0.02, generator=g)
        _init_blocks(tower.blocks, cfg.width, cfg.intermediate_size,
                     cfg.layers, g)
    nn.init.normal_(v.patch_embed.weight,
                    std=v.patch_embed.in_features ** -0.5, generator=g)
    nn.init.zeros_(v.patch_embed.bias)
    hd = v.head
    nn.init.normal_(hd.probe, std=0.02, generator=g)
    nn.init.normal_(hd.in_proj_weight, std=hd.width ** -0.5, generator=g)
    for lin in (hd.out_proj, hd.fc1, hd.fc2, t.head):
        nn.init.normal_(lin.weight, std=lin.in_features ** -0.5, generator=g)
        nn.init.zeros_(lin.bias)
    nn.init.normal_(t.token_embedding.weight, std=0.02, generator=g)
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    model.logit_scale.fill_(math.log(10.0))
    model.logit_bias.fill_(-10.0)
    return model


def cast_siglip(model: Siglip, dtype: torch.dtype) -> Siglip:
    """``model.to(dtype)`` that keeps the logit scale and bias fp32, as
    flax keeps every parameter fp32 under a bf16 compute dtype (ln 10 in
    bf16 would scale the logits by 9.94, not 10); in place."""
    scale, bias = model.logit_scale.data, model.logit_bias.data
    model.to(dtype)
    model.logit_scale.data = scale.float()
    model.logit_bias.data = bias.float()
    return model


def create_siglip(cfg: SiglipConfig, seed: int = 0,
                  dtype: torch.dtype = torch.float32,
                  device="cpu") -> Siglip:
    """:class:`Siglip` with :func:`init_siglip`'s seeded weights, in eval
    mode on ``device`` with parameters in ``dtype`` (the logit scale and
    bias fp32: :func:`cast_siglip`)."""
    model = init_siglip(Siglip(cfg), seed).to(device)
    return cast_siglip(model, dtype).eval()
