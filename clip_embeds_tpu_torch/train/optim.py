"""AdamW with the CLIP weight-decay split, plain Adam for the PACL/SPARC
heads, and global-norm clipping (counterpart of
``clip_embeds_tpu/train/optim.py``).

Parameters of rank < 2, biases and LayerNorm gains get no weight decay
(open_clip ``main.py``; the JAX ``_no_decay``); the rest do. The split is
two parameter groups of one ``torch.optim.AdamW``, whose update is optax's
``adamw`` (decoupled decay, scaled by the learning rate). Only trainable
parameters (``requires_grad``) enter the optimizer, as a frozen parameter
gets optax ``set_to_zero``: no update and no decay.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn


def _no_decay(name: str, param: torch.Tensor) -> bool:
    parts = name.split(".")
    if param.ndim < 2 or "bias" in parts:
        return True
    # a LayerNorm gain: the flax 'scale' of ln_1 / ln_2 / ln_pre / ...
    return len(parts) > 1 and parts[-2].startswith("ln") and \
        parts[-1] == "weight"


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether it gets weight decay."""
    return {name: not _no_decay(name, p)
            for name, p in model.named_parameters()}


def adamw(model: nn.Module, lr: float = 5e-6, beta1: float = 0.9,
          beta2: float = 0.98, eps: float = 1e-6,
          weight_decay: float = 0.2) -> torch.optim.AdamW:
    """AdamW over ``model``'s trainable parameters with CLIP defaults
    (beta2 0.98, eps 1e-6): one group with ``weight_decay``, one without.
    The learning rate is set before each update by the train state."""
    mask = decay_mask(model)
    groups: Tuple[list, list] = ([], [])
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups[0 if mask[name] else 1].append(p)
    return torch.optim.AdamW(
        [{"params": groups[0], "weight_decay": weight_decay},
         {"params": groups[1], "weight_decay": 0.0}],
        lr=lr, betas=(beta1, beta2), eps=eps)


def adam(model: nn.Module, lr: float = 1e-4) -> torch.optim.Adam:
    """optax ``adam`` over ``model``'s trainable parameters: b1 0.9, b2
    0.999, eps 1e-8 added outside the square root (torch's ``Adam`` puts it
    there too), no weight decay. The PACL/SPARC heads' optimiser; the
    reference trains them at lr 1e-4 with no schedule."""
    return torch.optim.Adam([p for p in model.parameters()
                             if p.requires_grad],
                            lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor],
                        max_norm: float) -> Optional[torch.Tensor]:
    """Scale the gradients in place by ``max / max(norm, max)``, optax's
    ``clip_by_global_norm`` (no epsilon, unlike ``clip_grad_norm_``); the
    norm covers the given parameters' gradients. Returns the norm (a 0-d
    tensor, no host sync) or None when no parameter has a gradient."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return None
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def adamw_over(params: Iterable[torch.Tensor], lr: float = 2e-5,
               beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0) -> torch.optim.AdamW:
    """optax ``adamw`` over the given tensors (a LoRA adapter tree's, or a
    model's fully fine-tuned parameters), one group: the VLM2Vec trainer's
    optimiser with the HF Trainer's defaults (beta2 0.999, eps 1e-8,
    weight decay 0). The learning rate is set before each update by the
    train state."""
    return torch.optim.AdamW(list(params), lr=lr, betas=(beta1, beta2),
                             eps=eps, weight_decay=weight_decay)
