"""CoCa's loss (counterpart of ``clip_embeds_tpu/losses/coca.py``; open_clip
``CoCaLoss``): the weighted InfoNCE plus the teacher-forced captioning
cross-entropy over the non-pad labels (open_clip's recipe weights: caption
2.0, contrastive 1.0)."""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel.mesh import global_mean
from .clip_loss import clip_loss, softmax_cross_entropy


def caption_loss(logits: torch.Tensor, labels: torch.Tensor,
                 pad_id: int = 0) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` [B, L, V] against ``labels`` [B, L]
    over the labels that are not ``pad_id`` (fp32); under a process group,
    over the global batch's (``parallel/mesh.py global_mean``)."""
    flat_labels = labels.reshape(-1)
    valid = flat_labels != pad_id
    ce = softmax_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               torch.where(valid, flat_labels, 0))
    return global_mean((ce * valid).sum(), valid.sum())


def coca_loss(model_out: Dict[str, torch.Tensor],
              caption_loss_weight: float = 2.0,
              clip_loss_weight: float = 1.0,
              pad_id: int = 0) -> Dict[str, torch.Tensor]:
    """{'contrastive_loss', 'caption_loss', 'loss'} of a CoCa forward's
    output (weighted; 'loss' is their sum)."""
    contrastive = clip_loss(model_out["image_features"],
                            model_out["text_features"],
                            model_out["logit_scale"]) * clip_loss_weight
    captioning = caption_loss(model_out["logits"], model_out["labels"],
                              pad_id) * caption_loss_weight
    return {"contrastive_loss": contrastive, "caption_loss": captioning,
            "loss": contrastive + captioning}
