"""SPARC global + local loss and the patch-grouping forward math
(counterpart of ``clip_embeds_tpu/losses/sparc.py``).

Reference: Patch-Aligned-Contrastive-Learning/model/pacl.py:380-485 (sparc
model forward: token-patch similarity, min-max normalization, sigma
threshold, alignment-weighted patch grouping) and :516-584 (SparcLoss:
0.5 * global InfoNCE + 1.0 * masked token-level pairwise contrastive, both
directions). Similarities and logits are fp32, as the JAX einsums'
``preferred_element_type``.
"""

from __future__ import annotations

import torch

from ..models.clip import l2_normalize
from .clip_loss import clip_loss


def sparc_group_patches(
    v_patch_embed: torch.Tensor,   # [B, P, D]
    l_token_embed: torch.Tensor,   # [B, T, D]
    sigma: float,
) -> torch.Tensor:
    """Group patches per text token -> [B, T, D] (pacl.py:453-478)."""
    sim = torch.einsum("btd,bpd->btp", l_token_embed.float(),
                       v_patch_embed.float())
    sim_min = sim.amin(dim=-1, keepdim=True)
    sim_max = sim.amax(dim=-1, keepdim=True)
    sim = (sim - sim_min) / (sim_max - sim_min + 1e-8)
    sim = torch.where(sim < sigma, torch.zeros_like(sim), sim)
    weights = sim / (sim.sum(dim=-1, keepdim=True) + 1e-8)
    return torch.einsum("btp,bpd->btd", weights,
                        v_patch_embed.to(weights.dtype))


def masked_pairwise_contrastive_loss(
    a: torch.Tensor,      # [B, L, D]
    b: torch.Tensor,      # [B, L, D]
    mask: torch.Tensor,   # [B, L] float, 1 = valid token
    inv_temperature: float,
) -> torch.Tensor:
    """Per-sample token-to-token InfoNCE with invalid columns masked
    (pacl.py:522-556): CE over [L] classes with identity targets, -1e8
    added to invalid columns, mean over valid rows."""
    logits = torch.einsum("bmd,bnd->bmn", a.float(), b.float()) \
        * inv_temperature
    logits = logits + ((1.0 - mask) * -1e8)[:, None, :]
    logz = torch.logsumexp(logits, dim=-1)                 # [B, L]
    diag = torch.diagonal(logits, dim1=-2, dim2=-1)        # [B, L]
    per_token = logz - diag
    return (per_token * mask).sum() / mask.sum()


def sparc_loss(
    v_patch_embed: torch.Tensor,            # [B, P, D] unnormalised
    l_token_embed: torch.Tensor,            # [B, T, D] normalised
    l_grouped_v_patch_embed: torch.Tensor,  # [B, T, D] normalised
    language_mask: torch.Tensor,            # [B, T] float
    temperature: float = 1.0,
    global_weight: float = 0.5,
    local_weight: float = 1.0,
) -> torch.Tensor:
    inv_t = 1.0 / temperature
    global_img = l2_normalize(v_patch_embed.mean(dim=1))
    global_txt = l2_normalize(l_token_embed.mean(dim=1))
    global_loss = clip_loss(global_img, global_txt,
                            torch.tensor(inv_t, device=global_img.device))
    loss_vl = masked_pairwise_contrastive_loss(
        l_grouped_v_patch_embed, l_token_embed, language_mask, inv_t)
    loss_lv = masked_pairwise_contrastive_loss(
        l_token_embed, l_grouped_v_patch_embed, language_mask, inv_t)
    local_loss = (loss_vl + loss_lv) / 2
    return global_weight * global_loss + local_weight * local_loss
