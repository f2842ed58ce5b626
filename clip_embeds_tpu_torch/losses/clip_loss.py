"""Contrastive losses (counterpart of ``clip_embeds_tpu/losses/clip_loss.py``):
InfoNCE (+ NegCLIP hard texts), distillation, PACL, VLM2Vec embedding.

Pure functions over one device's full feature batch. Logits are fp32: the
features (bf16 under bf16 compute) are multiplied in fp32, as the JAX
``einsum(..., preferred_element_type=float32)``.

Hard-text semantics: the text batch carries H extra hard-negative captions
after the B originals; images score against all B + H texts, while only the
B original texts score back against images.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _logits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float().t())


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-row CE against integer labels. logits [N, C], labels [N]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return logz - picked


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor,
              logit_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric InfoNCE over the batch (open_clip ``ClipLoss``)."""
    logits_img = logit_scale * _logits(image_features, text_features)
    if logit_bias is not None:
        logits_img = logits_img + logit_bias
    labels = torch.arange(image_features.shape[0],
                          device=image_features.device)
    loss_i = softmax_cross_entropy(logits_img, labels).mean()
    loss_t = softmax_cross_entropy(logits_img.t(), labels).mean()
    return (loss_i + loss_t) / 2


def clip_loss_hard_text(image_features: torch.Tensor,       # [B, D]
                        text_features: torch.Tensor,        # [B, D]
                        hard_text_features: torch.Tensor,   # [H, D]
                        logit_scale: torch.Tensor,
                        hard_valid: Optional[torch.Tensor] = None,  # [H]
                        ) -> torch.Tensor:
    """NegCLIP loss with appended hard negative captions: image rows see
    B + H text columns with target i (columns of padding hard rows,
    ``hard_valid`` False, are masked to -inf); text rows score only the B
    images."""
    b = image_features.shape[0]
    all_text = torch.cat([text_features, hard_text_features], dim=0)
    logits_img = logit_scale * _logits(image_features, all_text)  # [B, B+H]
    if hard_valid is not None:
        col_mask = torch.cat([
            torch.ones(b, dtype=torch.bool, device=hard_valid.device),
            hard_valid.bool()])
        logits_img = logits_img.masked_fill(~col_mask[None, :],
                                            float("-inf"))
    labels = torch.arange(b, device=image_features.device)
    loss_i = softmax_cross_entropy(logits_img, labels).mean()
    logits_txt = logit_scale * _logits(text_features, image_features)
    loss_t = softmax_cross_entropy(logits_txt, labels).mean()
    return (loss_i + loss_t) / 2


def _kd_cross_entropy(teacher_logits: torch.Tensor,
                      student_logits: torch.Tensor) -> torch.Tensor:
    """-(softmax(teacher) * log_softmax(student)).sum(1).mean(0)."""
    t = torch.softmax(teacher_logits.float(), dim=1)
    ls = torch.log_softmax(student_logits.float(), dim=1)
    return -(t * ls).sum(dim=1).mean(dim=0)


def distill_clip_loss(image_features: torch.Tensor,
                      text_features: torch.Tensor,
                      logit_scale: torch.Tensor,
                      dist_image_features: torch.Tensor,
                      dist_text_features: torch.Tensor,
                      dist_logit_scale: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(contrastive_loss, distill_loss) (open_clip ``DistillClipLoss``):
    symmetric InfoNCE on the student plus the KD cross-entropy between the
    teacher's logits and the student's, both directions, halved. Pass the
    teacher's features detached."""
    logits_img = logit_scale * _logits(image_features, text_features)
    t_logits_img = dist_logit_scale * _logits(dist_image_features,
                                              dist_text_features)
    labels = torch.arange(image_features.shape[0],
                          device=image_features.device)
    contrastive = (softmax_cross_entropy(logits_img, labels).mean()
                   + softmax_cross_entropy(logits_img.t(), labels).mean()) / 2
    distill = (_kd_cross_entropy(t_logits_img, logits_img)
               + _kd_cross_entropy(t_logits_img.t(), logits_img.t())) / 2
    return contrastive, distill


def pacl_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                   temperature: float = 0.1) -> torch.Tensor:
    """PACL's in-batch InfoNCE with a fixed temperature (logit scale
    1 / temperature, nothing learned)."""
    return clip_loss(image_features, text_features,
                     torch.tensor(1.0 / temperature,
                                  device=image_features.device))


def embedding_contrastive_loss(query_reps: torch.Tensor,
                               target_reps: torch.Tensor,
                               temperature: float = 0.02) -> torch.Tensor:
    """VLM2Vec's one-directional contrastive loss:
    CE(query @ target^T / T) with diagonal targets."""
    logits = _logits(query_reps, target_reps) / temperature
    labels = torch.arange(query_reps.shape[0], device=query_reps.device)
    return softmax_cross_entropy(logits, labels).mean()


@torch.no_grad()
def clip_metrics(image_features: torch.Tensor, text_features: torch.Tensor,
                 logit_scale: torch.Tensor) -> Dict[str, torch.Tensor]:
    """In-batch retrieval accuracy, both directions."""
    logits = logit_scale * _logits(image_features, text_features)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return {
        "i2t_acc": (logits.argmax(-1) == labels).float().mean(),
        "t2i_acc": (logits.argmax(0) == labels).float().mean(),
    }
