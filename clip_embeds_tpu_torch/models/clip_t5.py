"""CLIP-FlanT5: CLIP vision tower + projector + T5 encoder-decoder
(counterpart of ``clip_embeds_tpu/models/clip_t5.py``), the backbone of
t2v_metrics' default VQAScore model (clip-flant5-xxl).

LLaVA-style vision features (the hidden states after block
``feature_layer``, -2, of the port's :class:`~.vit.VisionTransformer`,
selected by ``feature_select``, through the 2-layer projector) are spliced
into the T5 *encoder*'s input embeddings at the image sentinel; the
decoder teacher-forces the answer. The tower holds only the blocks the tap
runs (``CLIPT5Config.tower_blocks``, 23 of ViT-L/14-336's 24) and no
``ln_post`` or output projection, as a flax ``CLIPT5.init`` creates none;
its attention takes ``ops/attention.py``'s 'auto' route (the flash kernel
in bf16 on the card). Module names are the flax ones (``vision_tower``,
``multi_modal_projector``, ``t5``). ``quant_t5`` ('' | 'dynamic' |
'static') builds the T5 projections as int8 QuantLinear
(``models/quant.py quantize_clip_t5_trunk`` fills them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..core.config import VisionConfig
from .llava import (
    MultiModalProjector,
    _gather_rows,
    expand_like_tokens,
    splice_positions,
)
from .quant import Quant
from .t5 import T5Config, T5ForConditionalGeneration, shift_right
from .vit import VisionTransformer


@dataclasses.dataclass(frozen=True)
class CLIPT5Config:
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    feature_layer: int = -2
    feature_select: str = "patch"
    vision_quick_gelu: bool = True
    decoder_start_token_id: int = 0
    pad_id: int = 0

    @property
    def tower_blocks(self) -> int:
        """The vision blocks the hidden tap runs (and the tower holds)."""
        return self.vision.layers + 1 + self.feature_layer

    @property
    def n_image_tokens(self) -> int:
        n = self.vision.num_patches
        if self.feature_select == "cls_patch":
            return n + 1
        if self.feature_select == "cls":
            return 1
        return n


class CLIPT5(nn.Module):
    def __init__(self, cfg: CLIPT5Config, quant_t5: Quant = ""):
        super().__init__()
        self.cfg = cfg
        self.vision_tower = VisionTransformer(
            cfg.vision, embed_dim=cfg.vision.width,
            quick_gelu=cfg.vision_quick_gelu)
        del self.vision_tower.transformer.resblocks[cfg.tower_blocks:]
        del self.vision_tower.ln_post, self.vision_tower.proj
        self.multi_modal_projector = MultiModalProjector(cfg.vision.width,
                                                         cfg.t5.d_model)
        self.t5 = T5ForConditionalGeneration(cfg.t5, quant_t5)

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> projected image tokens [B, n_image, d_model]."""
        hidden = self.vision_tower(pixel_values,
                                   hidden_layer=self.cfg.feature_layer)
        select = self.cfg.feature_select
        if select == "patch":
            feats = hidden[:, 1:]
        elif select == "cls_patch":
            feats = hidden
        elif select == "cls":
            feats = hidden[:, :1]
        else:
            raise ValueError(select)
        return self.multi_modal_projector(feats)

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                labels: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                decoder_attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Decoder logits [B, T, vocab] teacher-forced on
        ``shift_right(labels)``. input_ids [B, L] hold one sentinel each;
        labels [B, T] hold IGNORE_INDEX pads."""
        return self.forward_with_features(
            input_ids, self.encode_images(pixel_values), labels,
            attention_mask, decoder_attention_mask)

    def forward_with_features(
        self, input_ids: torch.Tensor, image_features: torch.Tensor,
        labels: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """:meth:`forward` with precomputed image features [B, n_image,
        d_model] (:meth:`encode_images`): the scorer encodes each image
        once and splices its features into every text's encoder input. The
        encoder is bidirectional, so nothing past the features is shared
        across texts."""
        n_image = image_features.shape[1]
        text_embeds = self.t5.shared(input_ids.clamp_min(0))
        _, is_image, text_gather, image_gather = splice_positions(
            input_ids, n_image)
        text_part = _gather_rows(text_embeds, text_gather)
        image_part = _gather_rows(image_features.to(text_part.dtype),
                                  image_gather)
        inputs_embeds = torch.where(is_image[..., None], image_part,
                                    text_part)
        enc_mask = None
        if attention_mask is not None:
            enc_mask = expand_like_tokens(attention_mask.int(), input_ids,
                                          n_image, 1).bool()
        decoder_input_ids = shift_right(labels, self.cfg.decoder_start_token_id,
                                        self.cfg.pad_id)
        enc = self.t5.encode(inputs_embeds=inputs_embeds,
                             attention_mask=enc_mask)
        return self.t5.decode(decoder_input_ids, enc, decoder_attention_mask,
                              enc_mask)
