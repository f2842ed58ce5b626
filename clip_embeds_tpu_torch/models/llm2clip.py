"""LLM2CLIP (microsoft/LLM2CLIP-Openai-L-14-336; counterpart of
``clip_embeds_tpu/models/llm2clip.py``): a CLIP ViT-L/14-336 vision tower
and an MLP adapter that maps precomputed LLM2Vec text embeddings into the
CLIP space.

The vision tower is the port's composable ViT (QuickGELU): its attention is
the flash kernel (#4) on the card in bf16 at 577 rows, as JAX's ViT reaches
its Pallas kernel. The adapter is N pre-LN residual MLP blocks
(x + fc2(gelu(fc1(ln(x))))), then LayerNorm and Linear to the CLIP width.
Module names: ``vision_model.*`` (open_clip's ViT; ``proj`` is HF's
``visual_projection`` transposed) and ``text_adapter.adaptor.{i}.ln`` /
``fn.0`` / ``fn.3``, ``text_adapter.adaptor.{N}`` (the LayerNorm) and
``.{N+1}`` (the Linear), HF's. :func:`load_llm2clip_state_dict` takes HF's
checkpoint layout (``vision_model.*`` of a CLIPVisionModel,
``visual_projection.weight``, ``text_adapter.*``) and raises on another
adapter layout, as JAX's converter does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import torch
from torch import nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .vit import VisionTransformer


@dataclasses.dataclass(frozen=True)
class LLM2CLIPConfig:
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    embed_dim: int = 1280              # CLIP joint space
    text_embedding_dim: int = 4096     # LLM2Vec (Llama-3-8B) output
    adaptor_layers: int = 4
    expansion_factor: int = 2
    vision_quick_gelu: bool = True


class LinearBlock(nn.Module):
    """x + fc2(gelu(fc1(ln(x)))); ``fn`` keeps HF's Sequential indices."""

    def __init__(self, dim: int, expansion_factor: int):
        super().__init__()
        self.ln = nn.LayerNorm(dim)
        self.fn = nn.Sequential(nn.Linear(dim, dim * expansion_factor),
                                nn.GELU(), nn.Identity(),
                                nn.Linear(dim * expansion_factor, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(self.ln(x))


class TextAdapter(nn.Module):
    def __init__(self, cfg: LLM2CLIPConfig):
        super().__init__()
        d = cfg.text_embedding_dim
        self.adaptor = nn.Sequential(
            *(LinearBlock(d, cfg.expansion_factor)
              for _ in range(cfg.adaptor_layers)),
            nn.LayerNorm(d), nn.Linear(d, cfg.embed_dim))


class LLM2CLIP(nn.Module):
    def __init__(self, cfg: LLM2CLIPConfig = LLM2CLIPConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = VisionTransformer(
            cfg.vision, cfg.embed_dim, cfg.vision_quick_gelu)
        self.text_adapter = TextAdapter(cfg)

    def get_image_features(self, pixel_values: torch.Tensor,
                           normalize: bool = False) -> torch.Tensor:
        """[B, S, S, 3] -> [B, embed_dim] (pooled CLS, visual projection)."""
        pooled, _ = self.vision_model(pixel_values)
        return l2_normalize(pooled) if normalize else pooled

    def image_patches(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Raw patch hidden states [B, N, width] (the PACL heads' tap)."""
        return self.vision_model(pixel_values, hidden_layer=-1)[:, 1:]

    def get_text_features(self, llm_embeddings: torch.Tensor,
                          normalize: bool = False) -> torch.Tensor:
        """LLM2Vec embeddings [B, text_embedding_dim] -> [B, embed_dim]."""
        head = self.text_adapter.adaptor[-1]
        x = self.text_adapter.adaptor(llm_embeddings.to(head.weight.dtype))
        return l2_normalize(x) if normalize else x

    def forward(self, pixel_values: torch.Tensor,
                llm_embeddings: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.get_image_features(pixel_values, normalize=True),
                self.get_text_features(llm_embeddings, normalize=True))


def llm2clip_state_dict_from_hf(sd: Mapping[str, Any]) -> dict:
    """HF's LLM2CLIP checkpoint -> the port model's state dict: the
    CLIPVisionModel's q/k/v packed (``core/convert.py
    convert_hf_clip_vision_state_dict``), ``visual_projection`` as
    ``vision_model.proj``, the adapter as it is. KeyError where the
    adapter has another layout (no ``adaptor.0.fn.0``)."""
    from ..core.convert import _t, _vision_tower, \
        convert_hf_clip_vision_state_dict

    if "text_adapter.adaptor.0.fn.0.weight" not in sd:
        raise KeyError("text_adapter.adaptor.0.fn.0.weight missing — "
                       "unexpected LLM2CLIP adapter layout")
    out = _vision_tower(convert_hf_clip_vision_state_dict(
        sd, prefix="vision_model."), "vision_model")
    out["vision_model.proj"] = _t(sd["visual_projection.weight"]
                                  .detach().float().numpy().T)
    out.update({k: v.detach().float() for k, v in sd.items()
                if k.startswith("text_adapter.")})
    return out


def load_llm2clip_state_dict(model: LLM2CLIP, sd: Mapping[str, Any]
                             ) -> LLM2CLIP:
    """Load HF's LLM2CLIP checkpoint layout (strict)."""
    model.load_state_dict(llm2clip_state_dict_from_hf(sd))
    return model

