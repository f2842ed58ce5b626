"""LLaVA-1.5: CLIP vision tower + MLP projector + Llama decoder
(counterpart of ``clip_embeds_tpu/models/llava.py``).

* vision features from the hidden states after block ``feature_layer``
  (-2) of the port's :class:`~.vit.VisionTransformer`, selected by
  ``feature_select`` in {'patch', 'cls_patch', 'cls'};
* a 2-layer GELU projector (``multi_modal_projector.linear_{1,2}``);
* the image sentinel ``IMAGE_TOKEN_INDEX`` (-200) expanded into a fixed
  block of ``n_image_tokens`` slots by a gather (static shapes);
* :meth:`Llava.prefill` / :meth:`Llava.suffix_logits`: the image+question
  prefix run once per image, its per-layer K/V replayed across the
  candidate texts (VQAScore's m x n reuse);
* :meth:`Llava.embed_last_token` / :meth:`Llava.embed_mixed`: VLM2Vec's
  last-token pooling, L2-normalised; the mixed form masks the image block
  of imageless rows and re-derives their RoPE positions.

Module names are the flax ones (``vision_tower``, ``multi_modal_projector``,
``language_model``). The vision tower holds only the blocks the hidden
tap runs (``LlavaConfig.tower_blocks``, 23 of ViT-L/14-336's 24) and no
``ln_post`` or output projection, as a flax ``Llava.init`` creates none.
``lora_rank`` / ``lora_alpha`` give the trunk's projections the
unmaterialized LoRA side-path, the vision tower excluded as in the
reference; ``remat`` recomputes each trunk block in the backward (the
tower's, frozen in every mode that trains adapters, build no graph). Not
ported: ``scan_llm`` and ``stack_llava_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .layers import exact_gelu
from .llama import KV, LlamaConfig, LlamaForCausalLM
from .quant import Quant, linear
from .vit import VisionTransformer

IMAGE_TOKEN_INDEX = -200
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    feature_layer: int = -2
    feature_select: str = "patch"  # 'patch' | 'cls_patch' | 'cls'
    vision_quick_gelu: bool = True  # openai CLIP-ViT-L-336 tower

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


def llava_tiny_config() -> LlavaConfig:
    from .llama import llama_tiny_config

    return LlavaConfig(
        llama=llama_tiny_config(),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )


def splice_positions(input_ids: torch.Tensor, n_image: int
                     ) -> Tuple[torch.Tensor, ...]:
    """Index maps for expanding one image sentinel into n_image slots.

    Returns (image_pos [B], out_is_image [B, F], text_gather [B, F],
    image_gather [B, F]) where F = L - 1 + n_image."""
    b, l = input_ids.shape
    final_len = l - 1 + n_image
    image_pos = (input_ids == IMAGE_TOKEN_INDEX).int().argmax(dim=1)
    j = torch.arange(final_len, device=input_ids.device).expand(b, final_len)
    p = image_pos[:, None]
    is_image = (j >= p) & (j < p + n_image)
    text_gather = torch.where(j < p, j, (j - n_image + 1).clamp(0, l - 1))
    image_gather = (j - p).clamp(0, n_image - 1)
    return image_pos, is_image, text_gather, image_gather


def expand_like_tokens(values: torch.Tensor, input_ids: torch.Tensor,
                       n_image: int, image_fill) -> torch.Tensor:
    """Expand a per-token array (labels / attention mask) to the spliced
    length, filling image slots with ``image_fill``."""
    _, is_image, text_gather, _ = splice_positions(input_ids, n_image)
    gathered = torch.gather(values, 1, text_gather)
    return torch.where(is_image, torch.full_like(gathered, image_fill),
                       gathered)


def _gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x [B, N, D] gathered along N by index [B, F] -> [B, F, D]."""
    return torch.gather(x, 1, index[..., None].expand(-1, -1, x.shape[-1]))


def place_in_order(mask: torch.Tensor, features: torch.Tensor,
                   embeds: torch.Tensor) -> torch.Tensor:
    """``embeds`` [B, L, D] with the positions where ``mask`` [B, L] is set
    taken, in order, by the rows of ``features`` [B, S, D] (the
    reference's index_put / masked_scatter, as a cumsum gather)."""
    idx = (torch.cumsum(mask.long(), dim=1) - 1).clamp(0,
                                                       features.shape[1] - 1)
    gathered = _gather_rows(features.to(embeds.dtype), idx)
    return torch.where(mask[..., None], gathered, embeds)


def tapped_tower(vision: VisionConfig, feature_layer: int,
                 quick_gelu: bool) -> VisionTransformer:
    """The CLIP tower a hidden tap at ``feature_layer`` (-2) reads: the
    blocks up to the tap and no ``ln_post`` or output projection, which
    the tap never reaches (a flax init creates none of them)."""
    tower = VisionTransformer(vision, embed_dim=vision.width,
                              quick_gelu=quick_gelu)
    del tower.transformer.resblocks[vision.layers + 1 + feature_layer:]
    del tower.ln_post, tower.proj
    return tower


class MultiModalProjector(nn.Module):
    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.linear_1 = linear(False, in_features, hidden_size)
        self.linear_2 = linear(False, hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(exact_gelu(self.linear_1(x)))


class Llava(nn.Module):
    """LLaVA-1.5. ``quant_llm`` ('' | 'dynamic' | 'static') builds the
    Llama trunk's projections as int8 QuantLinear (``quantize_llava_trunk``
    fills them). Attention takes ``ops/attention.py``'s 'auto' route: the
    flash kernel for the vision tower and the trunk's unmasked prefill in
    bf16 on the card, as the JAX model does on the TPU; a padded trunk
    (every embedding call) takes plain attention, as JAX does.
    ``lora_rank`` > 0 enables the LoRA side-path of the trunk's
    projections (adapters attached by ``models/lora.py attach_lora``)."""

    def __init__(self, cfg: LlavaConfig, quant_llm: Quant = "",
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        self.vision_tower = tapped_tower(cfg.vision, cfg.feature_layer,
                                         cfg.vision_quick_gelu)
        self.multi_modal_projector = MultiModalProjector(
            cfg.vision.width, cfg.llama.hidden_size)
        self.language_model = LlamaForCausalLM(
            cfg.llama, quant_llm, lora_rank, lora_alpha, remat)

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] -> projected image tokens [B, n_image, hidden]."""
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

    def merge(self, input_ids: torch.Tensor,
              image_features: torch.Tensor) -> torch.Tensor:
        """Embed text and splice image features at the sentinel."""
        n_image = image_features.shape[1]
        text_embeds = self.language_model.embed(input_ids.clamp_min(0))
        _, is_image, text_gather, image_gather = splice_positions(
            input_ids, n_image)
        text_part = _gather_rows(text_embeds, text_gather)
        image_part = _gather_rows(image_features.to(text_part.dtype),
                                  image_gather)
        return torch.where(is_image[..., None], image_part, text_part)

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Logits [B, L - 1 + n_image, vocab]. input_ids [B, L] hold one
        IMAGE_TOKEN_INDEX each; attention_mask is bool [B, L]."""
        image_features = self.encode_images(pixel_values)
        embeds = self.merge(input_ids, image_features)
        mask = None
        if attention_mask is not None:
            mask = expand_like_tokens(attention_mask.int(), input_ids,
                                      image_features.shape[1], 1).bool()
        hidden = self.language_model.trunk(embeds, mask)
        return self.language_model.logits(hidden)

    def prefill(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                prefix_valid: Optional[torch.Tensor] = None
                ) -> Tuple[Tuple[KV, ...], torch.Tensor]:
        """Run the shared image+question prefix once: returns its per-layer
        post-RoPE K/V ((k, v), ...), each [B, kv_heads, F, hd] (what JAX's
        ``extract_prefix_kv`` reads out of the sown ``kv`` collection), and
        the expanded validity mask [B, F = Lp - 1 + n_image] to pass to the
        suffix pass. ``input_ids`` [B, Lp] are right-padded; their real
        length is ``prefix_valid``'s.

        No attention mask: the padding is strictly trailing, so causal
        attention keeps real positions pad-free, and a mask-free prefill
        takes the flash kernel on the card. Pad positions hold garbage K/V
        that the suffix pass masks."""
        image_features = self.encode_images(pixel_values)
        embeds = self.merge(input_ids, image_features)
        if prefix_valid is None:
            prefix_valid = torch.ones_like(input_ids, dtype=torch.bool)
        mask = expand_like_tokens(prefix_valid.int(), input_ids,
                                  image_features.shape[1], 1).bool()
        _, kv = self.language_model.trunk(embeds, None, sow_kv=True)
        return kv, mask

    def suffix_logits(self, suffix_ids: torch.Tensor,
                      prefix_kv: Sequence[KV], prefix_mask: torch.Tensor,
                      suffix_mask: torch.Tensor, prefix_len,
                      suffix_block: Optional[int] = None) -> torch.Tensor:
        """Candidate-text logits [n, Ls, vocab] against a cached prefix.

        ``prefix_len``: the real (unpadded) expanded prefix length, a
        scalar (a shared prefix) or [n] (a batched prefill of distinct
        images). With ``suffix_block`` each row holds candidate suffixes of
        that width concatenated; they attend block-diagonally, each reading
        the row's prefix K/V, and their positions restart per block."""
        embeds = self.language_model.embed(suffix_ids.clamp_min(0))
        n, ls = suffix_ids.shape
        base = torch.as_tensor(prefix_len, dtype=torch.long,
                               device=suffix_ids.device)
        base = base.expand(n) if base.dim() == 0 else base
        offsets = torch.arange(ls, device=suffix_ids.device)
        if suffix_block is not None:
            offsets = offsets % suffix_block
        positions = base[:, None] + offsets[None, :]
        hidden = self.language_model.trunk(
            embeds, suffix_mask, positions, prefix_kv=prefix_kv,
            prefix_mask=prefix_mask, suffix_block=suffix_block)
        return self.language_model.logits(hidden)

    def embed_mixed(self, input_ids: torch.Tensor,
                    pixel_values: torch.Tensor, image_valid: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """VLM2Vec pooling over a mixed image/text batch [B, D]: every row
        of ``input_ids`` [B, L] holds one sentinel (imageless rows in their
        padding), ``pixel_values`` are zeros where ``image_valid`` [B] is
        False, ``attention_mask`` [B, L] marks the real text tokens. The
        image block of an imageless row is masked out of attention and the
        positions are re-derived as ``max(cumsum(mask) - 1, 0)``, so its
        valid tokens see the text-only layout; the hidden state at the
        last valid index, L2-normalised."""
        image_features = self.encode_images(pixel_values)
        n_image = image_features.shape[1]
        embeds = self.merge(input_ids, image_features)
        _, is_image, text_gather, _ = splice_positions(input_ids, n_image)
        text_mask = torch.gather(attention_mask.int(), 1, text_gather)
        mask = torch.where(is_image, image_valid[:, None].int(), text_mask)
        positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0)
        hidden = self.language_model.trunk(embeds, mask.bool(), positions)
        idx = torch.arange(hidden.shape[1], device=hidden.device)[None, :]
        last = torch.where(mask.bool(), idx, -1).amax(dim=1)
        return l2_normalize(hidden[torch.arange(hidden.shape[0]), last])

    def embed_last_token(self, input_ids: torch.Tensor,
                         pixel_values: Optional[torch.Tensor] = None,
                         attention_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """VLM2Vec pooling [B, D]: the hidden state of the last valid
        token, at ``sum(mask) - 1`` (right padding), L2-normalised. With
        ``pixel_values`` each row of ``input_ids`` holds one sentinel;
        without, the rows are text only."""
        if pixel_values is not None:
            image_features = self.encode_images(pixel_values)
            embeds = self.merge(input_ids, image_features)
            if attention_mask is None:
                attention_mask = torch.ones_like(input_ids, dtype=torch.int)
            mask = expand_like_tokens(attention_mask.int(), input_ids,
                                      image_features.shape[1], 1)
        else:
            embeds = self.language_model.embed(input_ids.clamp_min(0))
            mask = (torch.ones_like(input_ids, dtype=torch.int)
                    if attention_mask is None else attention_mask.int())
        hidden = self.language_model.trunk(embeds, mask.bool())
        last = mask.sum(dim=1) - 1
        return l2_normalize(hidden[torch.arange(hidden.shape[0]), last])
