"""Qwen2-VL and Qwen2.5-VL: a native-resolution ViT with 2-D RoPE, the
patch merger, and the Qwen2 trunk with multimodal RoPE (counterpart of
``clip_embeds_tpu/models/qwen2_vl.py``).

As in JAX, one call takes images of one (t, h, w) grid ([B, L,
patch_dim]; mixed resolutions go in separate calls), the conv3d patchify
is one Linear over the processor's flattened patches (kernel == stride),
the vision RoPE tables and Qwen2.5's window plan are built on the host
from the grid and kept on the device a grid, the image features take the
image-pad tokens' places in order (a cumsum gather), and the trunk reads
[B, 3, L] (t, h, w) position ids (``models/llama.py mrope_cos_sin``).

The towers' attention is plain PyTorch, as it is a plain einsum outside
any Pallas kernel in JAX: fp32 logits, the frame mask (t > 1) or
Qwen2.5's window mask, probabilities cast to the values' dtype. The trunk
takes the flash kernel (#4, hd 128, GQA 28/4 repeated) on ``forward``
without a mask in bf16 on the card, plain attention under a padding mask;
with ``quant_llm`` ('dynamic' | 'static') its seven projections a layer
are int8 :class:`~.quant.QuantLinear`, ``int8_linear`` on the card (q/k/v
with their biases). Module names are the flax ones (``visual.patch_embed``,
``visual.blocks.{i}``, ``visual.ln_q``, ``visual.merger_fc{1,2}``,
``language_model``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .clip import l2_normalize
from .layers import LayerNorm, exact_gelu, quick_gelu
from .llama import LlamaConfig, LlamaForCausalLM, RMSNorm
from .llava import place_in_order
from .quant import Quant, linear


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584          # LM width (merger output)
    mlp_ratio: float = 4.0
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * \
            self.patch_size ** 2


def _qwen2_7b_text() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, rope_theta=1e6,
        rms_norm_eps=1e-6, attention_bias=True, mrope_section=(16, 24, 24),
    )


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    text: LlamaConfig = dataclasses.field(default_factory=_qwen2_7b_text)
    vision: Qwen2VLVisionConfig = dataclasses.field(
        default_factory=Qwen2VLVisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652


# -- host preprocessing -------------------------------------------------------


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """Qwen2VLImageProcessor.smart_resize: multiples of patch x merge,
    the pixel count kept in [min, max]."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio must be < 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def image_to_patches(image_chw: np.ndarray, cfg
                     ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """A normalised [C, H, W] (or [T, C, H, W]) array -> the processor's
    merge-grouped patches [(t h w), C tp p p], ordered (t, h_block,
    w_block, h_in, w_in) with features in (C, tp, ph, pw) order; frames
    repeated up to a multiple of ``temporal_patch_size``."""
    p, m, tp = cfg.patch_size, cfg.spatial_merge_size, \
        cfg.temporal_patch_size
    frames = image_chw[None] if image_chw.ndim == 3 else image_chw
    if frames.shape[0] % tp != 0:
        reps = np.repeat(frames[-1:], tp - frames.shape[0] % tp, axis=0)
        frames = np.concatenate([frames, reps], axis=0)
    c = frames.shape[1]
    grid_t = frames.shape[0] // tp
    grid_h, grid_w = frames.shape[2] // p, frames.shape[3] // p
    patches = frames.reshape(grid_t, tp, c, grid_h // m, m, p, grid_w // m,
                             m, p)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w, c * tp * p * p)
    return flat.astype(np.float32), (grid_t, grid_h, grid_w)


def get_rope_index(input_ids: np.ndarray,
                   grids: Sequence[Tuple[int, int, int]],
                   attention_mask: Optional[np.ndarray], cfg) -> np.ndarray:
    """3-D (t, h, w) position ids [B, 3, L] (get_rope_index,
    modeling_qwen2_vl.py:1392-1540, images only): text spans take 1-D
    positions, each image span its grid coordinates offset past the text
    before it. ``grids`` holds each image's (t, h, w) in order over the
    batch."""
    b, l = input_ids.shape
    m = cfg.vision.spatial_merge_size
    if attention_mask is None:
        attention_mask = np.ones((b, l), np.int64)
    out = np.ones((3, b, l), np.int64)
    image_index = 0
    for i in range(b):
        tokens = input_ids[i][attention_mask[i] == 1].tolist()
        spans: List[np.ndarray] = []
        st = 0
        while True:
            try:
                ed = tokens.index(cfg.image_token_id, st)
            except ValueError:
                break
            t, h, w = grids[image_index]
            image_index += 1
            gh, gw = h // m, w // m
            st_idx = spans[-1].max() + 1 if spans else 0
            text_len = ed - st
            spans.append(np.broadcast_to(np.arange(text_len),
                                         (3, text_len)) + st_idx)
            t_idx = np.repeat(np.arange(t), gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
            w_idx = np.tile(np.arange(gw), t * gh)
            spans.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + t * gh * gw
        if st < len(tokens):
            st_idx = spans[-1].max() + 1 if spans else 0
            text_len = len(tokens) - st
            spans.append(np.broadcast_to(np.arange(text_len),
                                         (3, text_len)) + st_idx)
        out[:, i, attention_mask[i] == 1] = np.concatenate(spans, axis=1)
    return out.transpose(1, 0, 2)


def _vision_rope(grid: Tuple[int, int, int], head_dim: int, merge: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [L, head_dim] numpy tables of a grid: rot_pos_emb's
    merge-grouped h / w position ids (modeling_qwen2_vl.py:357-384)."""
    t, h, w = grid
    hpos = np.arange(h)[:, None] * np.ones((1, w), np.int64)
    wpos = np.ones((h, 1), np.int64) * np.arange(w)[None, :]

    def group(x):
        x = x.reshape(h // merge, merge, w // merge, merge)
        return x.transpose(0, 2, 1, 3).reshape(-1)

    hpos, wpos = group(hpos), group(wpos)
    dim = head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, np.float32) / dim))
    h_ang = hpos[:, None].astype(np.float32) * inv_freq
    w_ang = wpos[:, None].astype(np.float32) * inv_freq
    ang = np.tile(np.concatenate([h_ang, w_ang], axis=-1), (t, 1))
    full = np.concatenate([ang, ang], axis=-1)
    return np.cos(full), np.sin(full)


@functools.lru_cache(maxsize=16)
def _tower_tables(grid: Tuple[int, int, int], head_dim: int, merge: int,
                  device: str) -> Tuple[torch.Tensor, ...]:
    """Qwen2-VL's tower tables of a grid, built on the host and kept on
    ``device`` (a copy from pageable host memory would wait for the device
    at every call; read-only, callers share them): the RoPE (cos, sin) and
    the frame mask (attention within each frame, cu_seqlens; None for one
    frame)."""
    t, h, w = grid
    cos, sin = _vision_rope(grid, head_dim, merge)
    frame = None
    if t > 1:
        fid = np.repeat(np.arange(t), h * w)
        frame = torch.from_numpy(fid[:, None] == fid[None, :]).to(device)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(
        device), frame


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _vision_attention(qkv: torch.Tensor, heads: int, cos: torch.Tensor,
                      sin: torch.Tensor, mask: Optional[torch.Tensor]
                      ) -> torch.Tensor:
    """The towers' attention as JAX writes it: q and k rotated in fp32 and
    rounded to the values' dtype, fp32 logits at hd^-1/2, ``where(mask,
    logits, -1e9)``, an fp32 softmax cast to the values' dtype for P.V.
    qkv [B, L, 3D] -> [B, L, D]."""
    b, l, d3 = qkv.shape
    hd = d3 // 3 // heads
    q, k, v = (t.reshape(b, l, heads, hd).transpose(1, 2)
               for t in qkv.split(d3 // 3, dim=-1))
    cos, sin = cos[None, None].float(), sin[None, None].float()
    q = (q.float() * cos + _rotate_half(q.float()) * sin).to(v.dtype)
    k = (k.float() * cos + _rotate_half(k.float()) * sin).to(v.dtype)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * hd ** -0.5
    if mask is not None:
        logits = torch.where(mask, logits, -1e9)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(b, l, d3 // 3)


class Qwen2VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen2VLVisionConfig):
        super().__init__()
        d, mlp = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
        self.heads = cfg.num_heads
        self.norm1 = LayerNorm(d, eps=1e-6)
        self.qkv = linear(False, d, 3 * d)
        self.proj = linear(False, d, d)
        self.norm2 = LayerNorm(d, eps=1e-6)
        self.fc1 = linear(False, d, mlp)
        self.fc2 = linear(False, mlp, d)

    def forward(self, x, cos, sin, mask=None):
        out = _vision_attention(self.qkv(self.norm1(x)), self.heads, cos,
                                sin, mask)
        x = x + self.proj(out)
        return x + self.fc2(quick_gelu(self.fc1(self.norm2(x))))


def _patch_embed(cfg) -> nn.Module:
    return linear(False, cfg.patch_dim, cfg.embed_dim, bias=False)


def _merger(cfg, x: torch.Tensor, ln_q, fc1, fc2) -> torch.Tensor:
    """PatchMerger: norm, then each merge^2 consecutive tokens as one row
    through a 2-layer GELU MLP."""
    b, l, _ = x.shape
    m2 = cfg.spatial_merge_size ** 2
    x = ln_q(x).reshape(b, l // m2, m2 * cfg.embed_dim)
    return fc2(exact_gelu(fc1(x)))


class Qwen2VisionTower(nn.Module):
    """The native-resolution tower over one (t, h, w) grid."""

    def __init__(self, cfg: Qwen2VLVisionConfig):
        super().__init__()
        self.cfg = cfg
        m2d = cfg.spatial_merge_size ** 2 * cfg.embed_dim
        self.patch_embed = _patch_embed(cfg)
        self.blocks = nn.ModuleList(Qwen2VisionBlock(cfg)
                                    for _ in range(cfg.depth))
        self.ln_q = LayerNorm(cfg.embed_dim, eps=1e-6)
        self.merger_fc1 = linear(False, m2d, m2d)
        self.merger_fc2 = linear(False, m2d, cfg.hidden_size)

    def forward(self, patches: torch.Tensor, grid: Tuple[int, int, int]
                ) -> torch.Tensor:
        """patches [B, L, patch_dim] (processor layout) -> merged image
        features [B, L / merge^2, hidden_size]."""
        cfg = self.cfg
        t, h, w = grid
        b, l, _ = patches.shape
        if l != t * h * w:
            raise ValueError(f"{l} patches for grid {grid}")
        dtype = self.patch_embed.weight.dtype
        x = self.patch_embed(patches.to(dtype))
        cos, sin, frame_mask = _tower_tables(
            (t, h, w), cfg.head_dim, cfg.spatial_merge_size, str(x.device))
        for block in self.blocks:
            x = block(x, cos, sin, frame_mask)
        return _merger(cfg, x, self.ln_q, self.merger_fc1, self.merger_fc2)


class Qwen2VL(nn.Module):
    """Qwen2-VL. ``quant_llm`` ('' | 'dynamic' | 'static') builds the
    trunk's projections as int8 QuantLinear (``models/quant.py
    quantize_llava_trunk`` fills them); the tower, embeddings, norms and
    ``lm_head`` stay floating point."""

    def __init__(self, cfg: Qwen2VLConfig, quant_llm: Quant = ""):
        super().__init__()
        self.cfg = cfg
        self.visual = self._tower(cfg.vision)
        self.language_model = LlamaForCausalLM(cfg.text, quant_llm)

    _tower = Qwen2VisionTower

    def merge(self, input_ids: torch.Tensor, image_features: torch.Tensor
              ) -> torch.Tensor:
        """The image features at the image-pad positions, in order (the
        reference's masked_scatter; a cumsum gather here)."""
        return place_in_order(input_ids == self.cfg.image_token_id,
                              image_features, self.language_model.embed(
                                  input_ids.clamp_min(0)))

    def _embeds(self, input_ids, patches, grid):
        if patches is None:
            return self.language_model.embed(input_ids.clamp_min(0))
        return self.merge(input_ids, self.visual(patches, grid))

    def forward(self, input_ids: torch.Tensor,
                patches: Optional[torch.Tensor] = None,
                grid: Optional[Tuple[int, int, int]] = None,
                attention_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, L, vocab]; ``positions`` [B, 3, L] from
        :func:`get_rope_index` (default: 1-D positions)."""
        embeds = self._embeds(input_ids, patches, grid)
        mask = None if attention_mask is None else attention_mask.bool()
        hidden = self.language_model.trunk(embeds, mask, positions)
        return self.language_model.logits(hidden)

    def embed_last_token(self, input_ids: torch.Tensor,
                         patches: Optional[torch.Tensor] = None,
                         grid: Optional[Tuple[int, int, int]] = None,
                         attention_mask: Optional[torch.Tensor] = None,
                         positions: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """VLM2Vec pooling [B, D]: the hidden state at ``sum(mask) - 1``,
        L2-normalised."""
        embeds = self._embeds(input_ids, patches, grid)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.int)
        hidden = self.language_model.trunk(embeds, attention_mask.bool(),
                                           positions)
        last = attention_mask.int().sum(dim=1) - 1
        return l2_normalize(hidden[torch.arange(hidden.shape[0]), last])


# -- Qwen2.5-VL ---------------------------------------------------------------
#
# The tower differs from Qwen2-VL's in three ways: RMSNorm (eps 1e-6) and a
# SiLU gate/up/down MLP with biases; window attention, the merge groups
# reordered window-major and every block but ``fullatt_block_indexes``
# attending within its window; the merger RMS-normalises. The window
# permutation and segment ids depend on the grid only, so they are numpy
# on the host and the reorder is a gather.


@dataclasses.dataclass(frozen=True)
class Qwen25VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280            # HF hidden_size
    intermediate_size: int = 3420
    hidden_size: int = 3584          # HF out_hidden_size (merger output)
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * \
            self.patch_size ** 2


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig:
    text: LlamaConfig = dataclasses.field(default_factory=_qwen2_7b_text)
    vision: Qwen25VLVisionConfig = dataclasses.field(
        default_factory=Qwen25VLVisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652


def _window_plan(grid: Tuple[int, int, int], cfg: Qwen25VLVisionConfig
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, win_id) over the merge groups of a grid: perm[new] = the
    original group index (get_window_index's reorder), win_id[new] its
    window (per (t, win_h, win_w); ragged edges keep smaller windows)."""
    t, h, w = grid
    m = cfg.spatial_merge_size
    lh, lw = h // m, w // m
    vw = cfg.window_size // m // cfg.patch_size  # cells a window side
    pad_h, pad_w = (-lh) % vw, (-lw) % vw
    nwh, nww = (lh + pad_h) // vw, (lw + pad_w) // vw
    index = np.arange(t * lh * lw).reshape(t, lh, lw)
    padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
    padded[:, :lh, :lw] = index
    padded = padded.reshape(t, nwh, vw, nww, vw).transpose(
        0, 1, 3, 2, 4).reshape(t, nwh * nww, vw, vw)
    flat = padded.reshape(-1)
    perm = flat[flat != -100]
    win = np.broadcast_to(
        np.arange(t * nwh * nww).reshape(t, nwh * nww, 1, 1),
        padded.shape).reshape(-1)
    return perm, win[flat != -100]


@functools.lru_cache(maxsize=16)
def _window_tables(grid: Tuple[int, int, int], cfg: Qwen25VLVisionConfig,
                   device: str) -> Tuple[Optional[torch.Tensor], ...]:
    """Qwen2.5-VL's tower tables of a grid, built on the host and kept on
    ``device`` (read-only, callers share them): the window-major order of
    the merge groups (:func:`_window_plan`), the RoPE (cos, sin) in that
    order, the window mask and the frame mask (None for one frame) over
    the reordered tokens, and the inverse order."""
    t, h, w = grid
    m2 = cfg.spatial_merge_size ** 2
    n = t * h * w
    perm, win_id = _window_plan(grid, cfg)
    cos, sin = (a.reshape(n // m2, m2, -1)[perm].reshape(n, -1) for a in
                _vision_rope(grid, cfg.head_dim, cfg.spatial_merge_size))
    win = np.repeat(win_id, m2)  # token segment ids in the reordered layout
    frame = None
    if t > 1:
        lh, lw = h // cfg.spatial_merge_size, w // cfg.spatial_merge_size
        frame = np.repeat(perm // (lh * lw), m2)
        frame = frame[:, None] == frame[None, :]
    on = (lambda a: None if a is None else
          torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return (on(perm), on(cos), on(sin), on(win[:, None] == win[None, :]),
            on(frame), on(np.argsort(perm)))


class Qwen25VisionBlock(nn.Module):
    def __init__(self, cfg: Qwen25VLVisionConfig):
        super().__init__()
        d, mlp = cfg.embed_dim, cfg.intermediate_size
        self.heads = cfg.num_heads
        self.norm1 = RMSNorm(d, 1e-6)
        self.qkv = linear(False, d, 3 * d)
        self.proj = linear(False, d, d)
        self.norm2 = RMSNorm(d, 1e-6)
        self.gate_proj = linear(False, d, mlp)
        self.up_proj = linear(False, d, mlp)
        self.down_proj = linear(False, mlp, d)

    def forward(self, x, cos, sin, mask=None):
        out = _vision_attention(self.qkv(self.norm1(x)), self.heads, cos,
                                sin, mask)
        x = x + self.proj(out)
        h = self.norm2(x)
        return x + self.down_proj(torch.nn.functional.silu(
            self.gate_proj(h)) * self.up_proj(h))


class Qwen25VisionTower(nn.Module):
    """Qwen2.5-VL's window-attention tower over one (t, h, w) grid."""

    def __init__(self, cfg: Qwen25VLVisionConfig):
        super().__init__()
        self.cfg = cfg
        m2d = cfg.spatial_merge_size ** 2 * cfg.embed_dim
        self.patch_embed = _patch_embed(cfg)
        self.blocks = nn.ModuleList(Qwen25VisionBlock(cfg)
                                    for _ in range(cfg.depth))
        self.ln_q = RMSNorm(cfg.embed_dim, 1e-6)
        self.merger_fc1 = linear(False, m2d, m2d)
        self.merger_fc2 = linear(False, m2d, cfg.hidden_size)

    def forward(self, patches: torch.Tensor, grid: Tuple[int, int, int]
                ) -> torch.Tensor:
        """patches [B, L, patch_dim] -> merged image features [B, L /
        merge^2, hidden_size], in the grid's merge-group order."""
        cfg = self.cfg
        t, h, w = grid
        b, l, _ = patches.shape
        if l != t * h * w:
            raise ValueError(f"{l} patches for grid {grid}")
        m2 = cfg.spatial_merge_size ** 2
        x = self.patch_embed(patches.to(self.patch_embed.weight.dtype))
        perm, cos, sin, window_mask, full_mask, inverse = _window_tables(
            (t, h, w), cfg, str(patches.device))
        # merge groups window-major; the RoPE tables in the same order
        x = x.reshape(b, l // m2, m2, -1)[:, perm].reshape(b, l, -1)
        for i, block in enumerate(self.blocks):
            mask = full_mask if i in cfg.fullatt_block_indexes \
                else window_mask
            x = block(x, cos, sin, mask)
        x = _merger(cfg, x, self.ln_q, self.merger_fc1, self.merger_fc2)
        # back to the grid's merge-group order for the trunk's splice
        return x[:, inverse]


class Qwen25VL(Qwen2VL):
    """Qwen2.5-VL: the window tower and the Qwen2 M-RoPE trunk (no W8A8
    trunk in JAX, so none here)."""

    _tower = Qwen25VisionTower

    def __init__(self, cfg: Qwen25VLConfig):
        super().__init__(cfg)
