"""EVA towers (counterpart of ``clip_embeds_tpu/models/eva.py``).

EVA01 (timm ``eva_giant_patch14_224``, the EVA01-g-14 configs): a biased
conv patchify, a class token, a learned pos embed, no ln_pre; pre-LN blocks
with a fused qkv whose bias is [q_bias; 0; v_bias], a GELU MLP and LN eps
1e-6; the final LN ``norm``, CLS pooling and ``head`` to embed_dim. The
blocks are the port's composable :class:`~.layers.Transformer` at eps 1e-6,
so their attention goes through ``ops.attention.dot_product_attention``: the
flash kernel (#4) on the card in bf16 at 257 rows and head dim 88, as JAX's
``Transformer`` reaches its Pallas kernel. The tower keeps open_clip's timm
key layout (``visual.trunk.blocks.{i}.norm1`` / ``attn.qkv`` /
``attn.q_bias`` / ``attn.v_bias`` / ``attn.proj`` / ``norm2`` /
``mlp.fc1`` / ``mlp.fc2``): its ``state_dict`` gives those keys and
``load_state_dict`` takes them (and a fused ``attn.qkv.bias``), mapped to
and from the Transformer's names by two hooks.

EVA02 (timm ``eva02_*_clip_*``): the base/large variant has split q/k/v
projections (k without bias), a 2-D rotary embedding on q and k with the
class token left out and coordinates rescaled to ``ref_feat_shape``, a
LayerNorm on the attention output before ``proj`` and a SwiGLU MLP
(fc1_g / fc1_x -> SiLU gate -> LN -> fc2); the enormous variant the EVA01
qkv and a GELU MLP in post-norm blocks, without rope. Attention is plain
(fp32 logits), as JAX's einsum. Module names are timm's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import VisionConfig
from .layers import Transformer
from .timm_vit import PatchEmbed, merge_heads, plain_attention, split_heads

EPS = 1e-6


# timm key of an EVA01 block parameter -> the Transformer block's
_EVA01_KEYS = {
    "norm1.weight": "ln_1.weight", "norm1.bias": "ln_1.bias",
    "attn.qkv.weight": "attn.in_proj_weight",
    "attn.proj.weight": "attn.out_proj.weight",
    "attn.proj.bias": "attn.out_proj.bias",
    "norm2.weight": "ln_2.weight", "norm2.bias": "ln_2.bias",
    "mlp.fc1.weight": "mlp.c_fc.weight", "mlp.fc1.bias": "mlp.c_fc.bias",
    "mlp.fc2.weight": "mlp.c_proj.weight", "mlp.fc2.bias": "mlp.c_proj.bias",
}


def _eva01_from_timm(module, state_dict, prefix, *args) -> None:
    """Load pre-hook: timm's ``blocks.{i}.*`` -> ``blocks.resblocks.{i}.*``;
    ``q_bias`` / ``v_bias`` (k gets none) or a fused ``qkv.bias`` become
    ``in_proj_bias``. Keys already in the port's names pass unchanged."""
    i = 0
    while f"{prefix}blocks.{i}.norm1.weight" in state_dict:
        src, dst = f"{prefix}blocks.{i}.", f"{prefix}blocks.resblocks.{i}."
        for theirs, ours in _EVA01_KEYS.items():
            state_dict[dst + ours] = state_dict.pop(src + theirs)
        if src + "attn.qkv.bias" in state_dict:
            bias = state_dict.pop(src + "attn.qkv.bias")
        else:
            q = state_dict.pop(src + "attn.q_bias")
            v = state_dict.pop(src + "attn.v_bias")
            bias = torch.cat([q, torch.zeros_like(q), v])
        state_dict.pop(src + "attn.k_bias", None)
        state_dict[dst + "attn.in_proj_bias"] = bias
        i += 1


def _eva01_to_timm(module, state_dict, prefix, local_metadata) -> None:
    """State-dict hook: the Transformer's names -> timm's; ``in_proj_bias``
    -> ``q_bias`` / ``v_bias`` (its k part is zero in EVA)."""
    inverse = {v: k for k, v in _EVA01_KEYS.items()}
    for key in [k for k in state_dict if k.startswith(prefix + "blocks.")]:
        i, rest = key[len(prefix + "blocks.resblocks."):].split(".", 1)
        dst = f"{prefix}blocks.{i}."
        value = state_dict.pop(key)
        if rest == "attn.in_proj_bias":
            q, _, v = value.chunk(3)
            state_dict[dst + "attn.q_bias"] = q
            state_dict[dst + "attn.v_bias"] = v
        else:
            state_dict[dst + inverse[rest]] = value


class EVATrunk(nn.Module):
    def __init__(self, cfg: VisionConfig, embed_dim: int):
        super().__init__()
        w = cfg.width
        self.patch_embed = PatchEmbed(w, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, w))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, w))
        self.blocks = Transformer(w, cfg.layers, cfg.heads, cfg.mlp_ratio,
                                  quick_gelu=False, ln_eps=EPS)
        self.norm = nn.LayerNorm(w, eps=EPS)
        self.head = nn.Linear(w, embed_dim)
        self._register_load_state_dict_pre_hook(_eva01_from_timm,
                                                with_module=True)
        self._register_state_dict_hook(_eva01_to_timm)


def _with_cls(t, x: torch.Tensor) -> torch.Tensor:
    """[B, N, W] patches -> [CLS; patches] + pos_embed (timm Eva)."""
    cls = t.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
    return torch.cat([cls, x], dim=1) + t.pos_embed.to(x.dtype)


class EVAVisionTower(nn.Module):
    """[B, S, S, 3] -> (pooled [B, embed_dim], patch tokens [B, N, W])."""

    def __init__(self, cfg: VisionConfig, embed_dim: int):
        super().__init__()
        self.cfg = cfg
        self.trunk = EVATrunk(cfg, embed_dim)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.trunk
        x = t.norm(t.blocks(_with_cls(t, t.patch_embed(images))))
        return t.head(x[:, 0]), x[:, 1:]


# -- EVA02 -------------------------------------------------------------------

EVA02_SHAPES = {
    # timm_model_name -> (width, layers, head_width, mlp_ratio, variant)
    "eva02_base_patch16_clip_224": (768, 12, 64, 8 / 3, "swiglu"),
    "eva02_large_patch14_clip_224": (1024, 24, 64, 8 / 3, "swiglu"),
    "eva02_large_patch14_clip_336": (1024, 24, 64, 8 / 3, "swiglu"),
    "eva02_enormous_patch14_clip_224": (1792, 64, 112, 15360 / 1792, "post"),
}


def eva02_vision_config(timm_name: str, image_size: int) -> VisionConfig:
    width, layers, head_width, mlp_ratio, variant = EVA02_SHAPES[timm_name]
    patch = 16 if "patch16" in timm_name else 14
    if variant == "swiglu":
        return VisionConfig(
            image_size=image_size, patch_size=patch, width=width,
            layers=layers, head_width=head_width, mlp_ratio=mlp_ratio,
            tower="eva02", eva_rope=True, eva_swiglu=True,
            eva_attn_inner_norm=True, eva_ref_feat_shape=(16, 16),
        )
    return VisionConfig(
        image_size=image_size, patch_size=patch, width=width, layers=layers,
        head_width=head_width, mlp_ratio=mlp_ratio, tower="eva02",
        eva_post_norm=True,
    )


def eva02_rope_embed(grid: Tuple[int, int], head_dim: int,
                     ref_shape: Tuple[int, int] = (),
                     temperature: float = 10000.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(sin, cos), each [H*W, head_dim], fp32: timm RotaryEmbeddingCat with
    in_pixels=False (per-axis integer coordinates, rescaled by
    ref_shape / grid; bands 1 / T^(i / nb), nb = head_dim // 4; sin and cos
    repeated pairwise)."""
    nb = head_dim // 4
    bands = 1.0 / (temperature ** (np.arange(nb) / nb))
    ts = [np.arange(s, dtype=np.float64) for s in grid]
    if ref_shape:
        ts = [t / g * r for t, g, r in zip(ts, grid, ref_shape)]
    mesh = np.stack(np.meshgrid(*ts, indexing="ij"), axis=-1)  # [H, W, 2]
    pos = mesh[..., None] * bands                              # [H, W, 2, nb]
    n = grid[0] * grid[1]
    sin = np.repeat(np.sin(pos).reshape(n, -1), 2, axis=-1)
    cos = np.repeat(np.cos(pos).reshape(n, -1), 2, axis=-1)
    return sin.astype(np.float32), cos.astype(np.float32)


def _rot_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def _rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
          ) -> torch.Tensor:
    """Rope on the patch tokens; the class token (row 0) passes."""
    p = x[:, :, 1:]
    return torch.cat([x[:, :, :1], p * cos + _rot_pairs(p) * sin], dim=2)


class Eva02Attention(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        d = cfg.width
        self.heads = cfg.heads
        self.post = cfg.eva_post_norm
        if self.post:
            # fused qkv, BEiT bias layout [q; 0; v]
            self.qkv = nn.Linear(d, 3 * d, bias=False)
            self.q_bias = nn.Parameter(torch.empty(d))
            self.v_bias = nn.Parameter(torch.empty(d))
        else:
            self.q_proj = nn.Linear(d, d)
            self.k_proj = nn.Linear(d, d, bias=False)
            self.v_proj = nn.Linear(d, d)
        if cfg.eva_attn_inner_norm:
            self.norm = nn.LayerNorm(d, eps=EPS)
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, rope: Optional[Tuple[torch.Tensor,
                                                            torch.Tensor]]
                ) -> torch.Tensor:
        if self.post:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
            q, k, v = F.linear(x, self.qkv.weight, bias).chunk(3, dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q, k, v = (split_heads(t, self.heads) for t in (q, k, v))
        if rope is not None:
            q, k = (_rope(t, *rope).to(v.dtype) for t in (q, k))
        o = merge_heads(plain_attention(q, k, v))
        if hasattr(self, "norm"):
            o = self.norm(o)
        return self.proj(o)


class Eva02Mlp(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        d = cfg.width
        hidden = int(d * cfg.mlp_ratio)
        self.swiglu = cfg.eva_swiglu
        if self.swiglu:
            self.fc1_g = nn.Linear(d, hidden)
            self.fc1_x = nn.Linear(d, hidden)
            self.norm = nn.LayerNorm(hidden, eps=EPS)
        else:
            self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            h = self.norm(F.silu(self.fc1_g(x)) * self.fc1_x(x))
        else:
            h = F.gelu(self.fc1(x))
        return self.fc2(h)


class Eva02Block(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.post = cfg.eva_post_norm
        self.norm1 = nn.LayerNorm(cfg.width, eps=EPS)
        self.attn = Eva02Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.width, eps=EPS)
        self.mlp = Eva02Mlp(cfg)

    def forward(self, x: torch.Tensor, rope) -> torch.Tensor:
        if self.post:
            x = x + self.norm1(self.attn(x, rope))
            return x + self.norm2(self.mlp(x))
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class EVA02Trunk(nn.Module):
    def __init__(self, cfg: VisionConfig, embed_dim: int):
        super().__init__()
        w = cfg.width
        self.patch_embed = PatchEmbed(w, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, w))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, w))
        self.blocks = nn.ModuleList(Eva02Block(cfg)
                                    for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(w, eps=EPS)
        self.head = nn.Linear(w, embed_dim)


class EVA02VisionTower(nn.Module):
    """EVA02 trunk + CLIP head: [B, S, S, 3] -> (pooled, patch tokens)."""

    def __init__(self, cfg: VisionConfig, embed_dim: int):
        super().__init__()
        self.cfg = cfg
        self.trunk = EVA02Trunk(cfg, embed_dim)
        self._rope: Dict[Tuple[torch.device, torch.dtype], tuple] = {}

    def rope(self, device: torch.device, dtype: torch.dtype):
        """(sin, cos) in the compute dtype, as JAX casts them; None
        without rope."""
        cfg = self.cfg
        if not cfg.eva_rope:
            return None
        if (device, dtype) not in self._rope:
            g = cfg.grid_size
            self._rope[device, dtype] = tuple(
                torch.from_numpy(a).to(device, dtype) for a in
                eva02_rope_embed((g, g), cfg.width // cfg.heads,
                                 tuple(cfg.eva_ref_feat_shape) or ()))
        return self._rope[device, dtype]

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.trunk
        x = _with_cls(t, t.patch_embed(images))
        rope = self.rope(x.device, x.dtype)
        for block in t.blocks:
            x = block(x, rope)
        x = t.norm(x)
        return t.head(x[:, 0]), x[:, 1:]
