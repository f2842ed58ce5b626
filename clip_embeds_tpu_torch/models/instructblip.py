"""InstructBLIP (FlanT5) generative VQA stack (counterpart of
``clip_embeds_tpu/models/instructblip.py``).

An EVA-style vision tower feeds a Q-Former whose input is [query tokens;
instruction tokens]; the query slice's outputs are projected to the T5
width and prepended to the T5 encoder's question embeddings; the decoder
teacher-forces the answer, and the score is exp(-mean CE) over the answer
tokens. Reuses the retrieval stack's tower and Q-Former
(``models/blip2.py``) and the Flan-T5 encoder-decoder (``models/t5.py``).
Module names are the flax ones (``vision_model``, ``query_tokens``,
``word_embeddings``, ``position_embeddings``, ``qformer``,
``language_projection``, ``t5``). ``quant_t5`` builds the T5 projections
as int8 QuantLinear; the EVA-g tower and the Q-Former stay floating point.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.config import VisionConfig
from .blip2 import Blip2VisionTower, QFormer, QFormerConfig, QueryEmbeddings
from .quant import Quant, linear
from .t5 import T5Config, T5ForConditionalGeneration, shift_right


@dataclasses.dataclass(frozen=True)
class InstructBlipConfig:
    # EVA-g (lavis eva_vit.py giant: 1408 wide, 39 layers, MLP 6144)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=14, width=1408, layers=39,
            head_width=88, mlp_ratio=6144 / 1408,
        )
    )
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    num_query_tokens: int = 32
    decoder_start_token_id: int = 0
    pad_id: int = 0


class InstructBlipT5(QueryEmbeddings):
    def __init__(self, cfg: InstructBlipConfig, quant_t5: Quant = ""):
        super().__init__(cfg.qformer, cfg.num_query_tokens)
        self.cfg = cfg
        self.vision_model = Blip2VisionTower(cfg.vision)
        self.qformer = QFormer(cfg.qformer)
        self.language_projection = linear(False, cfg.qformer.hidden_size,
                                          cfg.t5.d_model)
        self.t5 = T5ForConditionalGeneration(cfg.t5, quant_t5)

    def encode_vision(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """The EVA-g tower alone, the part of the stack that does not read
        the text: the scorer caches it per image."""
        return self.vision_model(pixel_values)

    def query_features(self, pixel_values: torch.Tensor,
                       qformer_input_ids: torch.Tensor,
                       qformer_attention_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Projected query outputs [B, Q, d_model], the T5 encoder's
        prefix."""
        return self.query_features_from_embeds(
            self.vision_model(pixel_values), qformer_input_ids,
            qformer_attention_mask)

    def query_features_from_embeds(
        self, image_embeds: torch.Tensor, qformer_input_ids: torch.Tensor,
        qformer_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        hidden, mask = self.with_text(image_embeds, qformer_input_ids,
                                      qformer_attention_mask)
        nq = self.cfg.num_query_tokens
        out = self.qformer(hidden, image_embeds, mask, query_length=nq)
        return self.language_projection(out[:, :nq])

    def forward(self, pixel_values: torch.Tensor,
                qformer_input_ids: torch.Tensor, input_ids: torch.Tensor,
                labels: torch.Tensor,
                qformer_attention_mask: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                decoder_attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Decoder logits [B, T, vocab] teacher-forced on
        ``shift_right(labels)``: encoder embeddings = [query prefix;
        question embeddings]."""
        return self.forward_with_vision(
            self.vision_model(pixel_values), qformer_input_ids, input_ids,
            labels, qformer_attention_mask, attention_mask,
            decoder_attention_mask)

    def forward_with_vision(
        self, image_embeds: torch.Tensor, qformer_input_ids: torch.Tensor,
        input_ids: torch.Tensor, labels: torch.Tensor,
        qformer_attention_mask: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        decoder_attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """:meth:`forward` with the tower's output precomputed: the scorer
        runs the tower once an image and replays it across the candidate
        texts (the Q-Former and T5 read the text, so they run per pair)."""
        prefix = self.query_features_from_embeds(
            image_embeds, qformer_input_ids, qformer_attention_mask)
        b, nq = prefix.shape[:2]
        text_embeds = self.t5.shared(input_ids.clamp_min(0))
        inputs_embeds = torch.cat([prefix.to(text_embeds.dtype),
                                   text_embeds], dim=1)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.bool)
        ones = torch.ones(b, nq, dtype=torch.bool, device=input_ids.device)
        enc_mask = torch.cat([ones, attention_mask.bool()], dim=1)
        decoder_input_ids = shift_right(labels, self.cfg.decoder_start_token_id,
                                        self.cfg.pad_id)
        enc = self.t5.encode(inputs_embeds=inputs_embeds,
                             attention_mask=enc_mask)
        return self.t5.decode(decoder_input_ids, enc, decoder_attention_mask,
                              enc_mask)
