"""SigLIP sigmoid loss, the global-batch form (counterpart of
``clip_embeds_tpu/losses/siglip.py`` ``siglip_loss``; open_clip
loss.py:377-530 SigLipLoss).

Every (image, text) pair of the batch is a binary decision, positives on
the diagonal: ``-sum(logsigmoid(labels * logits)) / batch``.
``siglip_loss`` takes the batch it is given; ``siglip_loss_ring`` (JAX's
shard_map form, open_clip's ``SigLipLoss`` over ranks) takes each rank's
slice of the global batch and streams the text features around the ranks,
so no rank holds more than a slice's logits at a time, and equals
``siglip_loss`` on the global batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import data_world, ranks_mean, ring_shift


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


def siglip_loss_ring(image_features: torch.Tensor,
                     text_features: torch.Tensor,
                     logit_scale: torch.Tensor,
                     logit_bias: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The sigmoid loss of the global batch, of which this rank holds a
    slice of each side: the positives and this slice's negatives
    locally, then ``world - 1`` exchanges, each passing the text slice on
    to the next rank (``parallel/mesh.py ring_shift``, whose backward
    sends the gradient back), each adding its negatives; the value is
    the mean over the ranks (JAX's ``pmean``), each rank's backward its
    own, as DDP's averaging expects. Without a group, ``siglip_loss``."""
    loss = _sigmoid_pair_loss(image_features, text_features, logit_scale,
                              logit_bias, negative_only=False)
    neighbour = text_features
    for _ in range(data_world() - 1):
        neighbour = ring_shift(neighbour)
        loss = loss + _sigmoid_pair_loss(image_features, neighbour,
                                         logit_scale, logit_bias,
                                         negative_only=True)
    return ranks_mean(loss)
