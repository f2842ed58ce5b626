"""FastViT-MCI vision towers, the MobileCLIP-S1 / S2 image encoders
(counterpart of ``clip_embeds_tpu/models/fastvit.py``).

open_clip's ``MobileCLIP-S*.json`` build timm ``fastvit_mci1|2`` with pool
'avg' and proj null, so the trunk's classifier ``head.fc`` is the CLIP
projection. A conv stem of three MobileOne blocks (stride 4); four stages
of RepMixer, RepMixer, RepMixer and attention blocks, each block followed
by a ConvFFN (depthwise 7x7, 1x1 expand x3, GELU, 1x1); between stages a
PatchEmbed (large-kernel 7x7 s2 grouped conv, SE entering stages 2 and 3,
then a MobileOne 1x1); a RepCPE before stage 4; a final MobileOne 3x3 to
2 x dims[-1] with SE, average pool, ``head.fc``.

The tower holds the reparameterised inference form, as JAX does: every
train-time branch ensemble (MobileOne kxk + scale + skip BNs, the RepMixer
mixer - norm difference, the RepCPE identity, the large + small kernels,
the attention pre-BN, the layer scales) collapsed into one conv or linear
with a bias. ``load_state_dict`` takes an open_clip MobileCLIP-S checkpoint
unchanged (timm's unfolded training layout, ``visual.trunk.*``): a load
pre-hook folds it with the arithmetic of JAX's converter
(``convert_fastvit_state_dict``, copied here in torch). The folded keys
(``*.reparam_conv``, ``token_mixer.qkv``, ``mlp.{conv,fc1,fc2}``,
``head.fc``) load as they are. Attention (64 tokens at 256 px) is plain.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .timm_vit import merge_heads, plain_attention

SE_RD_RATIO = 0.0625  # SqueezeExcite reduction (rd_divisor=1: exact int())
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class FastViTConfig:
    image_size: int = 256
    layers: Tuple[int, ...] = (4, 12, 20, 4)
    dims: Tuple[int, ...] = (64, 128, 256, 512)
    mlp_ratio: float = 3.0
    # token mixer per stage: 'repmixer' | 'attention'
    token_mixers: Tuple[str, ...] = ("repmixer",) * 3 + ("attention",)
    se_downsamples: Tuple[bool, ...] = (False, False, True, True)
    pos_embed_stages: Tuple[int, ...] = (3,)  # RepCPE before these stages
    attn_head_dim: int = 32
    cls_ratio: float = 2.0  # final conv expansion
    embed_dim: int = 512

    @property
    def final_dim(self) -> int:
        return int(self.dims[-1] * self.cls_ratio)


MCI_FASTVIT_SHAPES: Dict[str, FastViTConfig] = {
    "fastvit_mci0": FastViTConfig(layers=(2, 6, 10, 2)),
    "fastvit_mci1": FastViTConfig(layers=(4, 12, 20, 4)),
    "fastvit_mci2": FastViTConfig(
        layers=(4, 12, 24, 4), dims=(80, 160, 320, 640)
    ),
}


class SqueezeExcite(nn.Module):
    """timm SqueezeExcite (rd_ratio 1/16, rd_divisor 1, ReLU / sigmoid)."""

    def __init__(self, dim: int):
        super().__init__()
        rd = max(1, int(dim * SE_RD_RATIO))
        self.fc1 = nn.Conv2d(dim, rd, 1)
        self.fc2 = nn.Conv2d(rd, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class RepConv(nn.Module):
    """A reparameterised branch ensemble: conv + bias [+ SE] [+ GELU]
    (MobileOneBlock, ReparamLargeKernelConv, RepMixer, RepCPE)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, use_se: bool = False,
                 use_act: bool = True):
        super().__init__()
        self.reparam_conv = nn.Conv2d(cin, cout, k, stride, k // 2,
                                      groups=groups)
        self.se = SqueezeExcite(cout) if use_se else None
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.reparam_conv(x)
        if self.se is not None:
            x = self.se(x)
        return F.gelu(x) if self.use_act else x


class ConvFFN(nn.Module):
    """Depthwise 7x7 (BN folded) -> 1x1 -> GELU -> 1x1 (layer scale
    folded into fc2)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.conv(x))))


class RepMixerBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        self.token_mixer = RepConv(dim, dim, 3, groups=dim, use_act=False)
        self.mlp = ConvFFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.token_mixer(x)
        return x + self.mlp(x)


class FoldedAttention(nn.Module):
    def __init__(self, dim: int, head_dim: int):
        super().__init__()
        self.heads = dim // head_dim
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        b, n, c = t.shape
        q, k, v = self.qkv(t).view(b, n, 3, self.heads, c // self.heads) \
            .permute(2, 0, 3, 1, 4)
        return self.proj(merge_heads(plain_attention(q, k, v)))


class AttentionBlock(nn.Module):
    """The pre-attention BatchNorm folded into qkv, layer_scale_1 into
    proj, layer_scale_2 into the FFN's fc2."""

    def __init__(self, dim: int, mlp_ratio: float, head_dim: int):
        super().__init__()
        self.token_mixer = FoldedAttention(dim, head_dim)
        self.mlp = ConvFFN(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.token_mixer(x.flatten(2).transpose(1, 2))
        x = x + t.transpose(1, 2).reshape(b, c, h, w)
        return x + self.mlp(x)


class PatchEmbedDown(nn.Module):
    def __init__(self, cin: int, dim: int, use_se: bool):
        super().__init__()
        self.proj = nn.Sequential(
            RepConv(cin, dim, 7, 2, groups=cin, use_se=use_se),
            RepConv(dim, dim, 1))


class FastViTStage(nn.Module):
    def __init__(self, cfg: FastViTConfig, si: int):
        super().__init__()
        dim = cfg.dims[si]
        if si > 0:
            self.downsample = PatchEmbedDown(cfg.dims[si - 1], dim,
                                             cfg.se_downsamples[si])
        if si in cfg.pos_embed_stages:
            self.pos_emb = RepConv(dim, dim, 7, groups=dim, use_act=False)
        attn = cfg.token_mixers[si] == "attention"
        self.blocks = nn.Sequential(*(
            AttentionBlock(dim, cfg.mlp_ratio, cfg.attn_head_dim) if attn
            else RepMixerBlock(dim, cfg.mlp_ratio)
            for _ in range(cfg.layers[si])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "downsample"):
            x = self.downsample.proj(x)
        if hasattr(self, "pos_emb"):
            x = self.pos_emb(x)
        return self.blocks(x)


class ClassifierHead(nn.Module):
    def __init__(self, dim: int, embed_dim: int):
        super().__init__()
        self.fc = nn.Linear(dim, embed_dim)


class FastViTTrunk(nn.Module):
    def __init__(self, cfg: FastViTConfig):
        super().__init__()
        d0 = cfg.dims[0]
        self.stem = nn.Sequential(RepConv(3, d0, 3, 2),
                                  RepConv(d0, d0, 3, 2, groups=d0),
                                  RepConv(d0, d0, 1))
        self.stages = nn.Sequential(*(FastViTStage(cfg, si)
                                      for si in range(len(cfg.layers))))
        self.final_conv = RepConv(cfg.dims[-1], cfg.final_dim, 3,
                                  groups=cfg.dims[-1], use_se=True)
        self.head = ClassifierHead(cfg.final_dim, cfg.embed_dim)
        self._register_load_state_dict_pre_hook(
            lambda m, sd, prefix, *a: _fold_train_layout(sd, prefix, cfg),
            with_module=True)


class FastViTTower(nn.Module):
    """[B, S, S, 3] -> (pooled [B, embed_dim], final-conv tokens
    [B, HW, C])."""

    def __init__(self, cfg: FastViTConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = FastViTTrunk(cfg)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.trunk
        x = images.to(t.head.fc.weight.dtype).permute(0, 3, 1, 2)
        x = t.final_conv(t.stages(t.stem(x)))
        return t.head.fc(x.mean(dim=(2, 3))), x.flatten(2).transpose(1, 2)


# -- the fold: timm's training layout -> the tower's weights ----------------
# (JAX's converter, ``clip_embeds_tpu/models/fastvit.py:293-505``, in torch:
# kernels stay in torch's [O, I/g, kh, kw] layout.)

def _first(sd: Mapping[str, Any], *keys: str) -> Optional[str]:
    """First present key among alternative timm / apple spellings."""
    for k in keys:
        if k in sd:
            return k
    return None


def _t(x) -> torch.Tensor:
    return x.detach().float() if torch.is_tensor(x) else \
        torch.as_tensor(x, dtype=torch.float32)


def _fold_bn(w: torch.Tensor, sd: Mapping[str, Any], bn: str,
             eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """An inference-mode BatchNorm2d folded into the conv before it."""
    inv = _t(sd[bn + ".weight"]) / torch.sqrt(_t(sd[bn + ".running_var"])
                                              + eps)
    return (w * inv[:, None, None, None],
            -_t(sd[bn + ".running_mean"]) * inv + _t(sd[bn + ".bias"]))


def _identity_kernel(out_chs: int, in_per_group: int, k: int
                     ) -> torch.Tensor:
    """RepVGG-style identity as a grouped conv kernel [O, I/g, k, k]."""
    w = torch.zeros(out_chs, in_per_group, k, k)
    c = k // 2
    for i in range(out_chs):
        w[i, i % in_per_group, c, c] = 1.0
    return w


def _pad_to(w: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad a [O, I/g, ks, ks] kernel to k x k (centred)."""
    p = (k - w.shape[-1]) // 2
    return F.pad(w, (p, p, p, p)) if p else w


def _mobileone(sd, pre: str, in_chs: int, out_chs: int, k: int,
               groups: int, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A train-mode MobileOneBlock: the BN-folded kxk branch, the 1x1 scale
    branch padded to kxk, and the identity-BN branch, summed."""
    in_pg = in_chs // groups
    w = torch.zeros(out_chs, in_pg, k, k)
    b = torch.zeros(out_chs)
    key = _first(sd, f"{pre}.conv_kxk.0.conv.weight",
                 f"{pre}.rbr_conv.0.conv.weight")
    if key is not None:
        wf, bf = _fold_bn(_t(sd[key]), sd, key.rsplit(".conv.weight", 1)[0]
                          + ".bn")
        w, b = w + wf, b + bf
    key = _first(sd, f"{pre}.conv_scale.conv.weight",
                 f"{pre}.rbr_scale.conv.weight")
    if key is not None:
        wf, bf = _fold_bn(_t(sd[key]), sd, key.rsplit(".conv.weight", 1)[0]
                          + ".bn")
        w, b = w + _pad_to(wf, k), b + bf
    key = _first(sd, f"{pre}.identity.weight", f"{pre}.rbr_skip.weight")
    if key is not None and in_chs == out_chs and stride == 1:
        wf, bf = _fold_bn(_identity_kernel(out_chs, in_pg, k), sd,
                          key.rsplit(".weight", 1)[0])
        w, b = w + wf, b + bf
    return w, b


def _se(sd, pre: str, dst: str, out: Dict[str, torch.Tensor]) -> None:
    for ours, theirs in (("fc1", ("fc1", "reduce")),
                         ("fc2", ("fc2", "expand"))):
        key = _first(sd, *(f"{pre}.{t}.weight" for t in theirs))
        if key is None:
            raise KeyError(f"SE weights not found under {pre!r}")
        out[f"{dst}.{ours}.weight"] = _t(sd[key])
        out[f"{dst}.{ours}.bias"] = _t(sd[key.rsplit(".weight", 1)[0]
                                          + ".bias"])


def _gamma(sd, pre: str) -> Optional[torch.Tensor]:
    key = _first(sd, f"{pre}.gamma", f"{pre}.weight")
    return None if key is None else _t(sd[key]).reshape(-1)


def _conv_ffn(sd, pre: str, ls: Optional[torch.Tensor],
              out: Dict[str, torch.Tensor]) -> None:
    w, b = _fold_bn(_t(sd[f"{pre}.conv.conv.weight"]), sd, f"{pre}.conv.bn")
    fc2_w, fc2_b = _t(sd[f"{pre}.fc2.weight"]), _t(sd[f"{pre}.fc2.bias"])
    if ls is not None:
        fc2_w, fc2_b = fc2_w * ls[:, None, None, None], fc2_b * ls
    out.update({f"{pre}.conv.weight": w, f"{pre}.conv.bias": b,
                f"{pre}.fc1.weight": _t(sd[f"{pre}.fc1.weight"]),
                f"{pre}.fc1.bias": _t(sd[f"{pre}.fc1.bias"]),
                f"{pre}.fc2.weight": fc2_w, f"{pre}.fc2.bias": fc2_b})


def _put(out: Dict[str, torch.Tensor], dst: str, w: torch.Tensor,
         b: torch.Tensor) -> None:
    out[f"{dst}.reparam_conv.weight"] = w
    out[f"{dst}.reparam_conv.bias"] = b


def fold_fastvit_state_dict(sd: Mapping[str, Any], cfg: FastViTConfig,
                            prefix: str = "") -> Dict[str, torch.Tensor]:
    """timm's training layout under ``prefix`` (a MobileCLIP-S trunk) ->
    the folded tower's state dict under the same prefix."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out: Dict[str, torch.Tensor] = {}
    d0 = cfg.dims[0]
    for i, (ci, co, k, g, s) in enumerate(((3, d0, 3, 1, 2),
                                           (d0, d0, 3, d0, 2),
                                           (d0, d0, 1, 1, 1))):
        _put(out, f"stem.{i}", *_mobileone(sd, f"stem.{i}", ci, co, k, g, s))
    for si, (depth, dim) in enumerate(zip(cfg.layers, cfg.dims)):
        spre = f"stages.{si}"
        if si > 0:
            lk = f"{spre}.downsample.proj.0"
            key = _first(sd, f"{lk}.large_conv.conv.weight",
                         f"{lk}.lkb_origin.conv.weight")
            if key is None:
                raise KeyError(f"large-kernel conv not found under {lk!r}")
            w, b = _fold_bn(_t(sd[key]), sd,
                            key.rsplit(".conv.weight", 1)[0] + ".bn")
            if f"{lk}.small_conv.conv.weight" in sd:
                ws, bs = _fold_bn(_t(sd[f"{lk}.small_conv.conv.weight"]), sd,
                                  f"{lk}.small_conv.bn")
                w, b = w + _pad_to(ws, w.shape[-1]), b + bs
            _put(out, lk, w, b)
            if cfg.se_downsamples[si]:
                _se(sd, f"{lk}.se", f"{lk}.se", out)
            pw = f"{spre}.downsample.proj.1"
            _put(out, pw, *_mobileone(sd, pw, dim, dim, 1, 1, 1))
        if si in cfg.pos_embed_stages:
            key = _first(sd, f"{spre}.pos_emb.pos_enc.weight",
                         f"{spre}.pos_emb.pe.weight",
                         f"{spre}.pos_emb.pe.0.weight")
            if key is None:
                raise KeyError(f"RepCPE conv not found under {spre!r}")
            _put(out, f"{spre}.pos_emb",
                 _t(sd[key]) + _identity_kernel(dim, 1, 7),
                 _t(sd[key.rsplit(".weight", 1)[0] + ".bias"]))
        for bi in range(depth):
            bpre = f"{spre}.blocks.{bi}"
            if cfg.token_mixers[si] == "attention":
                inv = _t(sd[f"{bpre}.norm.weight"]) / torch.sqrt(
                    _t(sd[f"{bpre}.norm.running_var"]) + BN_EPS)
                shift = _t(sd[f"{bpre}.norm.bias"]) \
                    - _t(sd[f"{bpre}.norm.running_mean"]) * inv
                qkv_w = _t(sd[f"{bpre}.token_mixer.qkv.weight"])
                key = _first(sd, f"{bpre}.token_mixer.qkv.bias")
                qkv_b = _t(sd[key]) if key else torch.zeros(qkv_w.shape[0])
                ls1 = _gamma(sd, f"{bpre}.layer_scale_1")
                proj_w = _t(sd[f"{bpre}.token_mixer.proj.weight"])
                proj_b = _t(sd[f"{bpre}.token_mixer.proj.bias"])
                if ls1 is not None:
                    proj_w, proj_b = proj_w * ls1[:, None], proj_b * ls1
                out.update({
                    f"{bpre}.token_mixer.qkv.weight": qkv_w * inv[None, :],
                    f"{bpre}.token_mixer.qkv.bias": qkv_b + qkv_w @ shift,
                    f"{bpre}.token_mixer.proj.weight": proj_w,
                    f"{bpre}.token_mixer.proj.bias": proj_b})
                _conv_ffn(sd, f"{bpre}.mlp",
                          _gamma(sd, f"{bpre}.layer_scale_2"), out)
            else:
                mix = f"{bpre}.token_mixer"
                wm, bm = _mobileone(sd, f"{mix}.mixer", dim, dim, 3, dim, 1)
                wn, bn = _mobileone(sd, f"{mix}.norm", dim, dim, 3, dim, 1)
                ls = _gamma(sd, f"{mix}.layer_scale")
                if ls is None:
                    ls = torch.ones(dim)
                _put(out, mix, _identity_kernel(dim, 1, 3)
                     + ls[:, None, None, None] * (wm - wn), ls * (bm - bn))
                _conv_ffn(sd, f"{bpre}.mlp",
                          _gamma(sd, f"{bpre}.layer_scale"), out)
    _put(out, "final_conv", *_mobileone(sd, "final_conv", cfg.dims[-1],
                                        cfg.final_dim, 3, cfg.dims[-1], 1))
    _se(sd, "final_conv.se", "final_conv.se", out)
    key = _first(sd, "head.fc.weight", "head.weight")
    if key is None:
        raise KeyError("classifier head not found (trunk.head.fc)")
    out["head.fc.weight"] = _t(sd[key])
    out["head.fc.bias"] = _t(sd[key.rsplit(".weight", 1)[0] + ".bias"])
    return {prefix + k: v for k, v in out.items()}


def _fold_train_layout(state_dict, prefix: str, cfg: FastViTConfig) -> None:
    """Load pre-hook of the trunk: a training-layout state dict (timm's
    MobileOne branches) is folded in place; a folded one passes."""
    if _first(state_dict, f"{prefix}stem.0.conv_kxk.0.conv.weight",
              f"{prefix}stem.0.rbr_conv.0.conv.weight") is None:
        return
    folded = fold_fastvit_state_dict(state_dict, cfg, prefix)
    for k in [k for k in state_dict if k.startswith(prefix)]:
        del state_dict[k]
    state_dict.update(folded)
