"""SigLIP sigmoid loss, the global-batch form (counterpart of
``clip_embeds_tpu/losses/siglip.py`` ``siglip_loss``; open_clip
loss.py:377-530 SigLipLoss).

Every (image, text) pair of the batch is a binary decision, positives on
the diagonal: ``-sum(logsigmoid(labels * logits)) / batch``. The ring form
(``siglip_loss_ring``, negatives streamed between ranks) is multi-GPU and
is ported with ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _sigmoid_pair_loss(image_features: torch.Tensor,
                       text_features: torch.Tensor,
                       logit_scale: torch.Tensor,
                       logit_bias: Optional[torch.Tensor],
                       negative_only: bool) -> torch.Tensor:
    """-sum(logsigmoid(labels * logits)) / local_batch (reference _loss):
    fp32 logits, labels -1 off the diagonal and +1 on it."""
    logits = logit_scale * torch.matmul(image_features.float(),
                                        text_features.float().t())
    if logit_bias is not None:
        logits = logits + logit_bias
    labels = -torch.ones_like(logits)
    if not negative_only:
        labels = labels + 2 * torch.eye(*logits.shape, dtype=logits.dtype,
                                        device=logits.device)
    return -F.logsigmoid(labels * logits).sum() / image_features.shape[0]


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor,
                logit_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global-batch sigmoid loss (all pairs, positives on the diagonal)."""
    return _sigmoid_pair_loss(image_features, text_features, logit_scale,
                              logit_bias, negative_only=False)
