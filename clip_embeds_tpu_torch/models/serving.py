"""Serving path: CLIP and SigLIP towers replayed block by block through
``ops.fused_block`` (counterpart of ``clip_embeds_tpu/models/serving.py``,
bf16 and W8A8 ViT and text towers).

Reads the weights of a :class:`~clip_embeds_tpu_torch.models.clip.CLIP`.
The sequence is padded once to a multiple of 16 before the block stack;
padded keys are masked through ``kv_valid`` and padded rows are dropped
after. For inference only.

The W8A8 towers (``prepare_int8_tower`` / ``prepare_int8_text_tower``)
are a list of ``fused_block_int8`` argument dicts whose int8 weights,
scales and static activation scales come from a calibrated quantised copy
of the tower (``models/quant.py``); the embeddings, LayerNorms and heads
are read from the fp model at each call, as the JAX package reads them
from its fp param tree.

The SigLIP towers (``models/siglip.py``: ViT-SO400M-14-SigLIP-384, head dim
72, MLP width 4304) take the same kernels with ``act="tanh"`` and
``ln_eps=1e-6``: the image tower's 729 tokens are padded to 736 rows
(``kv_valid`` 729), the 64-token text tower is bidirectional and pools its
last position; the post-LN and the MAP head run as a plain epilogue.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.fused_block import _ln as _ln_affine
from ..ops.fused_block import (
    fused_block,
    fused_block_int8,
    fused_block_supported,
)
from .clip import l2_normalize
from .layers import get_act
from .quant import calibrate_act_scales, quantize_model, quantize_siglip
from .text_transformer import text_global_pool
from .vit import patch_weight, patchify


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _block_weights(block, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """A ResidualAttentionBlock's weights in fused_block's argument order."""
    a, m = block.attn, block.mlp
    ws = (a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
          a.out_proj.bias, m.c_fc.weight, m.c_fc.bias, m.c_proj.weight,
          m.c_proj.bias,
          torch.stack([block.ln_1.weight, block.ln_1.bias]),
          torch.stack([block.ln_2.weight, block.ln_2.bias]))
    return tuple(w.to(dtype) for w in ws)


def _pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, n_pad - x.shape[1]))


def _encode_image(model, images, block_fn: Callable, normalize: bool,
                  dtype: torch.dtype, cls_fast_last: bool,
                  output_tokens: bool):
    """The fused image tower; ``block_fn(i, x, n_valid)`` runs block i on
    the padded sequence."""
    cfg = model.cfg.vision
    v = model.visual
    b = images.shape[0]

    x = patchify(images.to(dtype), cfg.patch_size)
    x = x @ patch_weight(v.conv1.weight.to(dtype)).t()
    cls = v.class_embedding.to(dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + v.positional_embedding.to(dtype)
    n_valid = x.shape[1]
    if v.ln_pre is not None:
        x = _ln_affine(x, v.ln_pre.weight, v.ln_pre.bias, 1e-5)
    x = _pad_rows(x, _round_up(n_valid, 16))

    # pool 'tok' reads only the CLS row of the last block's output, so the
    # last block runs in CLS-only form (k/v full, q/out/MLP one row)
    use_cls_fast = cls_fast_last and cfg.pool_type == "tok" \
        and not output_tokens
    for i in range(cfg.layers - 1 if use_cls_fast else cfg.layers):
        x = block_fn(i, x, n_valid)

    lnp = v.ln_post
    tokens = None
    if use_cls_fast:
        pooled = _cls_only_last_block(x, v.transformer.resblocks[-1],
                                      cfg.heads, n_valid,
                                      model.cfg.quick_gelu, dtype)
        # for 'tok', ln-then-pool and pool-then-ln agree on the CLS row
        pooled = _ln_affine(pooled, lnp.weight, lnp.bias, 1e-5)
    else:
        x = x[:, :n_valid]
        if cfg.final_ln_after_pool:
            pooled, tokens = v.pool(x)
            pooled = _ln_affine(pooled, lnp.weight, lnp.bias, 1e-5)
        else:
            pooled, tokens = v.pool(_ln_affine(x, lnp.weight, lnp.bias,
                                               1e-5))
    pooled = pooled @ v.proj.to(dtype)
    pooled = l2_normalize(pooled) if normalize else pooled
    return (pooled, tokens) if output_tokens else pooled


def fused_encode_image(
    model,                        # models.clip.CLIP (vit tower)
    images: torch.Tensor,         # [B, S, S, 3]
    normalize: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    cls_fast_last: bool = True,
    output_tokens: bool = False,
):
    """encode_image through fused blocks; returns [B, embed_dim].

    With ``output_tokens`` returns (pooled, tokens [B, N, width]) like the
    composable ``encode_image(output_tokens=True)``; token output reads
    every row, so the CLS-only last block is then off.
    """
    blocks = model.visual.transformer.resblocks

    def block_fn(i, x, n_valid):
        return fused_block(x, *_block_weights(blocks[i], dtype),
                           heads=model.cfg.vision.heads, kv_valid=n_valid,
                           quick_gelu=model.cfg.quick_gelu)

    return _encode_image(model, images, block_fn, normalize, dtype,
                         cls_fast_last, output_tokens)


def _cls_only_last_block(
    x: torch.Tensor,               # [B, n_pad, D] input to the final block
    block,                         # the final ResidualAttentionBlock
    heads: int,
    n_valid: int,
    quick_gelu: bool,
    dtype: torch.dtype,
) -> torch.Tensor:
    """Row-0 (CLS) output of the final residual block, as [B, D].

    With pool_type 'tok' nothing downstream reads the other rows, so only
    the k/v projections run over the full sequence; the query,
    out-projection and MLP run on one row. Plain PyTorch, numerics as the
    composable block.
    """
    b, n, d = x.shape
    hd = d // heads
    a, mlp = block.attn, block.mlp
    h = _ln_affine(x, block.ln_1.weight, block.ln_1.bias, 1e-5)
    wq, wk, wv = a.in_proj_weight.to(dtype).chunk(3, dim=0)
    bq, bk, bv = a.in_proj_bias.to(dtype).chunk(3)
    q = h[:, :1] @ wq.t() + bq                    # [B, 1, D]
    k = h @ wk.t() + bk                           # [B, n, D]
    v = h @ wv.t() + bv

    qh = q.view(b, 1, heads, hd).transpose(1, 2)
    kh = k.view(b, n, heads, hd).transpose(1, 2)
    vh = v.view(b, n, heads, hd).transpose(1, 2)
    logits = (qh.float() * hd ** -0.5) @ kh.float().transpose(-1, -2)
    # padded rows carry ln-of-zero garbage in k/v; mask them out
    key_ok = torch.arange(n, device=x.device) < n_valid
    logits = logits.masked_fill(~key_ok, float("-inf"))
    o = torch.softmax(logits, dim=-1) @ vh.float()
    o = o.transpose(1, 2).reshape(b, 1, d).to(dtype)

    r = x[:, :1] + (o @ a.out_proj.weight.to(dtype).t()
                    + a.out_proj.bias.to(dtype))
    t = _ln_affine(r, block.ln_2.weight, block.ln_2.bias, 1e-5)
    t = t @ mlp.c_fc.weight.to(dtype).t() + mlp.c_fc.bias.to(dtype)
    t = get_act(quick_gelu)(t)
    t = t @ mlp.c_proj.weight.to(dtype).t() + mlp.c_proj.bias.to(dtype)
    return (r + t)[:, 0]


def _encode_text(model, text_ids, block_fn: Callable, normalize: bool,
                 dtype: torch.dtype) -> torch.Tensor:
    """The fused text tower; ``block_fn(i, x, n_valid, causal)`` runs
    block i on the padded sequence."""
    cfg = model.cfg.text
    n_valid = text_ids.shape[1]
    x = model.token_embedding.weight.to(dtype)[text_ids]
    x = x + model.positional_embedding[:n_valid].to(dtype)
    x = _pad_rows(x, _round_up(n_valid, 16))

    causal = not cfg.no_causal_mask
    for i in range(cfg.layers):
        x = block_fn(i, x, n_valid, causal)
    x = x[:, :n_valid]
    x = _ln_affine(x, model.ln_final.weight, model.ln_final.bias, 1e-5)
    pooled, _ = text_global_pool(x, text_ids, cfg.pool_type)
    pooled = pooled @ model.text_projection.to(dtype)
    return l2_normalize(pooled) if normalize else pooled


def fused_encode_text(
    model,
    text_ids: torch.Tensor,        # int [B, ctx]
    normalize: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """encode_text through fused causal blocks (77 -> 80 rows)."""
    blocks = model.transformer.resblocks

    def block_fn(i, x, n_valid, causal):
        return fused_block(x, *_block_weights(blocks[i], dtype),
                           heads=model.cfg.text.heads, kv_valid=n_valid,
                           quick_gelu=model.cfg.quick_gelu, causal=causal)

    return _encode_text(model, text_ids, block_fn, normalize, dtype)


def fused_path_available(model) -> bool:
    """Whether both towers' block shapes pass ``fused_block_supported``."""
    v = model.cfg.vision
    if v.tower != "vit":
        return False
    t = model.cfg.text
    return (
        fused_block_supported(_round_up(v.num_patches + 1, 16), v.width,
                              v.heads, v.mlp_ratio)
        and fused_block_supported(_round_up(t.context_length, 16), t.width,
                                  t.heads, t.mlp_ratio)
    )


def fused_route(model, dtype: torch.dtype) -> bool:
    """Whether serving in ``dtype`` takes the fused-block kernels: on the
    card, in bf16 (the kernels' type), at shapes
    :func:`fused_path_available` takes. Elsewhere the composable towers
    serve, as the JAX package serves off the TPU."""
    return (model.visual.proj.is_cuda and dtype == torch.bfloat16
            and fused_path_available(model))


# -- W8A8 fused serving path -------------------------------------------------

# fused_block_int8's weight arguments, in order (the JAX package's)
INT8_BLOCK_ARGS = ("wqkv_q", "sqkv", "bqkv", "wo_q", "so", "bo", "w1_q",
                   "s1", "b1", "w2_q", "s2", "b2", "ln1", "ln2",
                   "act_scales")


@torch.no_grad()
def int8_block_args(block) -> Dict[str, torch.Tensor]:
    """A calibrated quantised ResidualAttentionBlock (``quant``) ->
    ``fused_block_int8`` arguments: int8 [out, in] weights, fp32 scales
    and biases, its LayerNorms and the four static activation scales."""
    a, m = block.attn, block.mlp
    return _int8_args((a.in_proj, a.out_proj, m.c_fc, m.c_proj), block)


def _int8_args(lins, block) -> Dict[str, torch.Tensor]:
    """The qkv, out, fc and proj QuantLinears ``lins`` and ``block``'s
    ``ln_1`` / ``ln_2`` as ``fused_block_int8`` arguments."""
    out: Dict[str, torch.Tensor] = {}
    for name, lin in zip(("qkv", "o", "1", "2"), lins):
        out[f"w{name}_q"] = lin.weight_q
        out[f"s{name}"] = lin.scale
        out[f"b{name}"] = lin.bias
    out["ln1"] = torch.stack([block.ln_1.weight, block.ln_1.bias])
    out["ln2"] = torch.stack([block.ln_2.weight, block.ln_2.bias])
    out["act_scales"] = torch.stack([lin.act_scale for lin in lins]).float()
    return out


def _int8_block(x, bp: Dict[str, torch.Tensor], heads: int, n_valid: int,
                quick_gelu: bool, causal: bool = False) -> torch.Tensor:
    return fused_block_int8(
        x, *(bp[k] for k in INT8_BLOCK_ARGS), heads=heads, kv_valid=n_valid,
        quick_gelu=quick_gelu, causal=causal)


def _prepare_int8(model, calib, method: str, tower: str,
                  dtype: Optional[torch.dtype]) -> Dict[str, List]:
    qmodel = quantize_model(model, "dynamic", dtype, tower=tower)
    with torch.inference_mode():
        calibrate_act_scales(qmodel, [calib], method)
    blocks = (qmodel.visual if tower == "visual" else qmodel).transformer
    return {"blocks": [int8_block_args(b) for b in blocks.resblocks]}


def prepare_int8_tower(model, calib_images: torch.Tensor,
                       dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, List]:
    """Quantise the ViT tower's block projections to int8 (from
    ``model``'s own weights: fp32 where the model is fp32, as the JAX
    package quantises its fp32 params) and calibrate the static activation
    scales on ``calib_images`` through a dynamic-mode copy computing in
    ``dtype`` (default: the model's)."""
    return _prepare_int8(model, calib_images, "encode_image", "visual",
                         dtype)


def prepare_int8_text_tower(model, calib_ids: torch.Tensor,
                            dtype: Optional[torch.dtype] = None
                            ) -> Dict[str, List]:
    """:func:`prepare_int8_tower` for the text tower, calibrated on token
    batches."""
    return _prepare_int8(model, calib_ids, "encode_text", "text", dtype)


def fused_encode_image_int8(
    model,
    qtower: Dict[str, List],      # prepare_int8_tower output
    images: torch.Tensor,
    normalize: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    cls_fast_last: bool = True,
    output_tokens: bool = False,
):
    """encode_image with W8A8 fused blocks. The CLS-only last block runs in
    ``dtype`` from the fp weights (one row is cheaper than an int8 block);
    ``output_tokens`` returns (pooled, tokens) and turns it off."""
    def block_fn(i, x, n_valid):
        return _int8_block(x, qtower["blocks"][i], model.cfg.vision.heads,
                           n_valid, model.cfg.quick_gelu)

    return _encode_image(model, images, block_fn, normalize, dtype,
                         cls_fast_last, output_tokens)


def fused_encode_text_int8(
    model,
    qtower: Dict[str, List],      # prepare_int8_text_tower output
    text_ids: torch.Tensor,
    normalize: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """encode_text with W8A8 fused causal blocks."""
    def block_fn(i, x, n_valid, causal):
        return _int8_block(x, qtower["blocks"][i], model.cfg.text.heads,
                           n_valid, model.cfg.quick_gelu, causal)

    return _encode_text(model, text_ids, block_fn, normalize, dtype)


# -- SigLIP fused serving ----------------------------------------------------


def siglip_fused_available(vision_cfg) -> bool:
    """Whether the fused kernels take a SigLIP vision tower's blocks (its
    tokens padded to a multiple of 16)."""
    n = _round_up(vision_cfg.num_patches, 16)
    return fused_block_supported(
        n, vision_cfg.width, vision_cfg.heads,
        vision_cfg.intermediate_size / vision_cfg.width)


def _siglip_block_weights(block, dtype: torch.dtype
                          ) -> Tuple[torch.Tensor, ...]:
    """A SiglipBlock's weights in fused_block's argument order."""
    ws = (block.in_proj.weight, block.in_proj.bias, block.out_proj.weight,
          block.out_proj.bias, block.fc1.weight, block.fc1.bias,
          block.fc2.weight, block.fc2.bias,
          torch.stack([block.ln_1.weight, block.ln_1.bias]),
          torch.stack([block.ln_2.weight, block.ln_2.bias]))
    return tuple(w.to(dtype) for w in ws)


def _encode_image_siglip(model, images, block_fn: Callable, normalize: bool,
                         dtype: torch.dtype) -> torch.Tensor:
    """The SigLIP image tower; ``block_fn(i, x, n_valid)`` runs block i on
    the padded sequence. No class token: every token feeds the MAP head,
    whose one probe query runs as a plain epilogue in ``dtype``."""
    cfg = model.cfg.vision
    v = model.vision_model
    x = patchify(images.to(dtype), cfg.patch_size)
    x = x @ v.patch_embed.weight.to(dtype).t() + v.patch_embed.bias.to(dtype)
    x = x + v.position_embedding.to(dtype)
    n_valid = x.shape[1]
    x = _pad_rows(x, _round_up(n_valid, 16))
    for i in range(cfg.layers):
        x = block_fn(i, x, n_valid)
    x = _ln_affine(x[:, :n_valid], v.post_layernorm.weight,
                   v.post_layernorm.bias, cfg.layer_norm_eps)
    pooled = v.head(x)
    return l2_normalize(pooled) if normalize else pooled


def _encode_text_siglip(model, input_ids, block_fn: Callable,
                        normalize: bool, dtype: torch.dtype) -> torch.Tensor:
    """The SigLIP text tower (bidirectional); ``block_fn(i, x, n_valid)``
    runs block i. Pooled = the LAST position -> final LN -> head."""
    cfg = model.cfg.text
    t = model.text_model
    n_valid = input_ids.shape[1]
    x = t.token_embedding.weight.to(dtype)[input_ids.long()]
    x = x + t.position_embedding[:n_valid].to(dtype)
    x = _pad_rows(x, _round_up(n_valid, 16))
    for i in range(cfg.layers):
        x = block_fn(i, x, n_valid)
    x = _ln_affine(x[:, n_valid - 1], t.final_layer_norm.weight,
                   t.final_layer_norm.bias, cfg.layer_norm_eps)
    pooled = x @ t.head.weight.to(dtype).t() + t.head.bias.to(dtype)
    return l2_normalize(pooled) if normalize else pooled


def _siglip_block_fn(blocks, cfg, dtype: torch.dtype) -> Callable:
    def block_fn(i, x, n_valid):
        return fused_block(x, *_siglip_block_weights(blocks[i], dtype),
                           heads=cfg.heads, kv_valid=n_valid, act="tanh",
                           ln_eps=cfg.layer_norm_eps)
    return block_fn


def fused_encode_image_siglip(
    model,                         # models.siglip.Siglip
    images: torch.Tensor,          # [B, S, S, 3]
    normalize: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Siglip.encode_image through fused blocks (tanh-GELU, eps 1e-6; 729
    tokens padded to 736 rows at SO400M/384); returns [B, width]."""
    block_fn = _siglip_block_fn(model.vision_model.blocks, model.cfg.vision,
                                dtype)
    return _encode_image_siglip(model, images, block_fn, normalize, dtype)


def fused_encode_text_siglip(
    model,                         # models.siglip.Siglip
    input_ids: torch.Tensor,       # int [B, ctx <= 64]
    normalize: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Siglip.encode_text through fused blocks (bidirectional attention,
    tanh-GELU, eps 1e-6; pooled = LAST token -> head projection)."""
    block_fn = _siglip_block_fn(model.text_model.blocks, model.cfg.text,
                                dtype)
    return _encode_text_siglip(model, input_ids, block_fn, normalize, dtype)


@torch.no_grad()
def siglip_int8_block_args(block) -> Dict[str, torch.Tensor]:
    """A calibrated quantised SiglipBlock -> ``fused_block_int8``
    arguments (as :func:`int8_block_args` for CLIP's block)."""
    return _int8_args((block.in_proj, block.out_proj, block.fc1, block.fc2),
                      block)


def _prepare_int8_siglip(model, calib, method: str, tower: str,
                         dtype: Optional[torch.dtype]) -> Dict[str, List]:
    qmodel = quantize_siglip(model, "dynamic", dtype, tower=tower)
    with torch.inference_mode():
        calibrate_act_scales(qmodel, [calib], method)
    return {"blocks": [siglip_int8_block_args(b)
                       for b in getattr(qmodel, tower).blocks]}


def prepare_int8_siglip_tower(model, calib_images: torch.Tensor,
                              dtype: Optional[torch.dtype] = None
                              ) -> Dict[str, List]:
    """Quantise the SigLIP vision tower's block projections to int8 (from
    ``model``'s own weights) and calibrate static activation scales on
    ``calib_images`` through a dynamic-mode copy computing in ``dtype``
    (default: the model's); patchify and the MAP head stay fp."""
    return _prepare_int8_siglip(model, calib_images, "encode_image",
                                "vision_model", dtype)


def prepare_int8_siglip_text_tower(model, calib_ids: torch.Tensor,
                                   dtype: Optional[torch.dtype] = None
                                   ) -> Dict[str, List]:
    """:func:`prepare_int8_siglip_tower` for the text tower, calibrated on
    token batches."""
    return _prepare_int8_siglip(model, calib_ids, "encode_text",
                                "text_model", dtype)


def _siglip_int8_block_fn(qtower, cfg) -> Callable:
    def block_fn(i, x, n_valid):
        bp = qtower["blocks"][i]
        return fused_block_int8(
            x, *(bp[k] for k in INT8_BLOCK_ARGS), heads=cfg.heads,
            kv_valid=n_valid, act="tanh", ln_eps=cfg.layer_norm_eps)
    return block_fn


def fused_encode_image_siglip_int8(
    model,                         # models.siglip.Siglip (fp parts)
    qtower: Dict[str, List],       # prepare_int8_siglip_tower output
    images: torch.Tensor,
    normalize: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Siglip.encode_image with W8A8 fused blocks (tanh-GELU, eps 1e-6);
    the MAP-head epilogue stays fp, as on the bf16 fused path."""
    return _encode_image_siglip(
        model, images, _siglip_int8_block_fn(qtower, model.cfg.vision),
        normalize, dtype)


def fused_encode_text_siglip_int8(
    model,                         # models.siglip.Siglip (fp parts)
    qtower: Dict[str, List],       # prepare_int8_siglip_text_tower output
    input_ids: torch.Tensor,
    normalize: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Siglip.encode_text with W8A8 fused blocks."""
    return _encode_text_siglip(
        model, input_ids, _siglip_int8_block_fn(qtower, model.cfg.text),
        normalize, dtype)
