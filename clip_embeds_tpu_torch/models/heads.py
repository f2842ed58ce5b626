"""PACL / SPARC patch-aligned projection heads (counterpart of
``clip_embeds_tpu/models/heads.py``).

Reference: Patch-Aligned-Contrastive-Learning/model/pacl.py. The heads are
small trainable modules on top of a *frozen* CLIP tower (pacl.py:97
requires_grad=False): their inputs are detached, as the JAX heads put them
under ``stop_gradient``. Variant semantics:

* ``open_clip_pacl`` (pacl.py:51-145): LN -> Dropout -> PatchProjection on
  patch tokens; LN -> Dropout -> Linear on the text CLS; sigmoid(10 * cosine)
  patch activations. The committed forward overrides activations with ones
  ("Eval only !!!!!!") — ``pooling='uniform'``; the commented-out training
  path is ``pooling='weighted'``.
* ``open_clip_pacl_rope``: RoPE on raw patches before projection.
* ``open_clip_pacl_rope_after``: RoPE on *projections* for the activation
  computation only; pooling weights the unrotated projections (always
  weighted: no uniform override).
* ``sparc`` (pacl.py:380-485): the same visual projection; the text
  projection applied to all text tokens; language mask = positions <=
  argmax(ids).

Submodule names mirror flax's (``visual_projection.ln``,
``visual_projection.proj.{linear,mlp_in,mlp_out}``, ``text_projection.ln``,
``text_projection.proj``), so ``core/convert.py`` maps the JAX params one to
one. Parameters are fp32; ``compute_dtype`` (default fp32) is flax's
``dtype``: LayerNorm statistics in fp32, the products in ``compute_dtype``.
Dropout draws its masks from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .clip import l2_normalize
from .layers import LayerNorm, exact_gelu

_ROPES = ("none", "before", "after")
_POOLINGS = ("uniform", "weighted")


def apply_rope(embeddings: torch.Tensor) -> torch.Tensor:
    """The paper's RoPE ablation transform (pacl.py:147-181) on [B, S, D].

    It splits even/odd channels but *concatenates* (not interleaves) the
    rotated halves — reproduced as it is."""
    _, seq_len, dim = embeddings.shape
    if dim % 2:
        raise ValueError(f"apply_rope needs an even width, got {dim}")
    dev = embeddings.device
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                              device=dev) / dim))
    angles = (torch.arange(seq_len, dtype=torch.float32, device=dev)[:, None]
              * inv_freq[None, :])
    sin, cos = angles.sin()[None], angles.cos()[None]
    x1 = embeddings[..., 0::2]
    x2 = embeddings[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the mask drawn from ``generator`` (on x's
    device; None: the default generator)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class PatchProjection(nn.Module):
    """Linear + (Linear -> exact GELU -> Linear) residual pair
    (pacl.py:35-48)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim)
        self.mlp_in = nn.Linear(in_dim, out_dim)
        self.mlp_out = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = exact_gelu(_dense(self.mlp_in, x, dtype))
        return _dense(self.linear, x, dtype) + _dense(self.mlp_out, h, dtype)


class _ProjStack(nn.Module):
    """LayerNorm (eps 1e-5) -> dropout -> projection."""

    def __init__(self, in_dim: int, out_dim: int, patch: bool,
                 dropout: float = 0.1):
        super().__init__()
        self.ln = LayerNorm(in_dim, eps=1e-5)
        self.dropout = dropout
        self.proj = (PatchProjection(in_dim, out_dim) if patch
                     else nn.Linear(in_dim, out_dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.ln(x.float()).to(dtype)
        if self.training:
            x = dropout(x, self.dropout, generator)
        if isinstance(self.proj, PatchProjection):
            return self.proj(x, dtype)
        return _dense(self.proj, x, dtype)


def patch_alignment(visual_patch_proj: torch.Tensor,
                    text_cls_proj: torch.Tensor) -> torch.Tensor:
    """sigmoid(10 * cosine(patch, text)) activations [B, P]
    (pacl.py:120-133)."""
    v = l2_normalize(visual_patch_proj).float()
    t = l2_normalize(text_cls_proj).float()
    return torch.sigmoid(torch.einsum("bpd,bd->bp", v, t) * 10.0)


class _Head(nn.Module):
    def __init__(self, patch_dim: int, text_dim: int, proj_dim: int,
                 dropout: float, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.visual_projection = _ProjStack(patch_dim, proj_dim, True,
                                            dropout)
        self.text_projection = _ProjStack(text_dim, proj_dim, False, dropout)

    def _project(self, patches: torch.Tensor, text: torch.Tensor,
                 generator: Optional[torch.Generator]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.compute_dtype or self.text_projection.proj.weight.dtype
        return (self.visual_projection(patches, dtype, generator),
                self.text_projection(text, dtype, generator))


class PACLHead(_Head):
    """Trainable PACL projections over frozen tower outputs.

    Call with patch tokens [B, P, patch_dim] and a text embedding
    [B, text_dim] (the CLIP text CLS, or a precomputed LLM2Vec embedding:
    the llm2clip variants differ only in text_dim and the frozen tower).
    Returns the L2-normalised (pooled image, text) embeddings [B, proj_dim].
    Dropout runs in train mode (``head.train()``).
    """

    def __init__(self, patch_dim: int, text_dim: int, proj_dim: int,
                 rope: str = "none", pooling: str = "uniform",
                 dropout: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None):
        if rope not in _ROPES or pooling not in _POOLINGS:
            raise ValueError(f"rope {rope!r}, pooling {pooling!r}")
        super().__init__(patch_dim, text_dim, proj_dim, dropout,
                         compute_dtype)
        self.rope = rope
        self.pooling = pooling

    def forward(self, visual_patches: torch.Tensor,
                text_embedding: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        visual_patches = visual_patches.detach()
        if self.rope == "before":
            visual_patches = apply_rope(visual_patches)
        vproj, tproj = self._project(visual_patches, text_embedding.detach(),
                                     generator)
        if self.rope == "after":
            acts = patch_alignment(apply_rope(vproj), tproj)
        elif self.pooling == "uniform":
            acts = torch.ones(vproj.shape[:2], dtype=vproj.dtype,
                              device=vproj.device)
        else:
            acts = patch_alignment(vproj, tproj)
        pooled = torch.einsum("bpd,bp->bd", vproj, acts.to(vproj.dtype))
        return l2_normalize(pooled), l2_normalize(tproj)


class SPARCHead(_Head):
    """SPARC projections: patches [B, P, patch_dim] and text tokens
    [B, T, text_dim] -> the unnormalised (vproj [B, P, proj_dim], tproj
    [B, T, proj_dim])."""

    def __init__(self, patch_dim: int, text_dim: int, proj_dim: int,
                 rope: bool = False, dropout: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(patch_dim, text_dim, proj_dim, dropout,
                         compute_dtype)
        self.rope = rope

    def forward(self, visual_patches: torch.Tensor,
                text_tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        visual_patches = visual_patches.detach()
        if self.rope:
            visual_patches = apply_rope(visual_patches)
        return self._project(visual_patches, text_tokens.detach(), generator)


@torch.no_grad()
def init_head(head: nn.Module, seed: int = 0) -> nn.Module:
    """flax's default initialisation in place, from a CPU generator seeded
    by ``seed``: Dense kernels lecun-normal (a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in), biases zero,
    LayerNorm scales one. The values are not the JAX package's: its keys
    draw other numbers."""
    g = torch.Generator().manual_seed(seed)
    for module in head.modules():
        if isinstance(module, nn.Linear):
            w = torch.empty(module.weight.shape)
            # flax truncated_normal: stddev / .87962566103423978 so that the
            # truncated distribution has variance 1 / fan_in
            std = (1.0 / module.in_features) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=g)
            module.weight.copy_(w)
            module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return head


def language_mask_from_ids(text_ids: torch.Tensor) -> torch.Tensor:
    """Float mask over token positions <= the EOT argmax
    (pacl.py:431-436)."""
    eot = text_ids.argmax(dim=-1)
    pos = torch.arange(text_ids.shape[1], device=text_ids.device)[None, :]
    return (pos <= eot[:, None]).float()
