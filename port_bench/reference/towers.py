"""The towers, as their papers and reference code describe them.

Parameters are a flat dict, name -> tensor, in open_clip's names (the
vision tower under ``visual.``, the text tower at top level); the EVA01
vision tower keeps timm's names under ``visual.trunk.`` (``attn.qkv``,
``attn.q_bias`` / ``attn.v_bias``; the key bias is zero and not a
parameter). Images are channels-last [B, S, S, 3], normalised.

* ViT (Radford et al. 2021; ``openai/CLIP`` ``clip/model.py``
  VisionTransformer): a stride-p conv without bias, [CLS; patches] plus
  the learned positions, ``ln_pre``, pre-LN blocks (packed in_proj,
  out_proj, c_fc, QuickGELU, c_proj), ``ln_post`` on the class token,
  ``proj``. The conv is written as the product of each patch with the
  flattened kernel, which it is, so that every product takes ``mm``.
* EVA01 (Fang et al. 2022; timm ``Eva`` as ``eva_giant_patch14_224``): a
  biased stride-p conv, [CLS; patches] plus positions, no ``ln_pre``,
  pre-LN blocks at eps 1e-6 with qkv bias [q_bias; 0; v_bias] and exact
  GELU, ``norm``, the class token, ``head`` (biased).
* Text (``clip/model.py`` encode_text): token embedding plus positions,
  causal pre-LN blocks, ``ln_final``, the row of the highest id (EOT),
  ``text_projection``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
# every matrix product of the towers goes through one of these: the plain
# fp32 product, or a lower precision's (``precision.py``) for the control
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def act_fn(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"activation {name!r}")


def attention(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
              w_o: torch.Tensor, b_o: torch.Tensor, heads: int,
              causal: bool, mm: MatMul = torch.matmul) -> torch.Tensor:
    """Multi-head self-attention, softmax over the keys (masked above the
    diagonal where causal), scale head_dim^-1/2."""
    b, n, d = x.shape
    hd = d // heads
    qkv = mm(x, w_qkv.t()) + b_qkv
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = mm(q, k.transpose(-1, -2)) * hd ** -0.5
    if causal:
        keep = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v)
    return mm(o.transpose(1, 2).reshape(b, n, d), w_o.t()) + b_o


def _clip_block(p: Params, pre: str, x: torch.Tensor, tower: Dict,
                causal: bool, mm: MatMul) -> torch.Tensor:
    eps, act = tower["ln_eps"], act_fn(tower["act"])
    d = x.shape[-1]
    h = F.layer_norm(x, (d,), p[pre + "ln_1.weight"], p[pre + "ln_1.bias"],
                     eps)
    x = x + attention(h, p[pre + "attn.in_proj_weight"],
                      p[pre + "attn.in_proj_bias"],
                      p[pre + "attn.out_proj.weight"],
                      p[pre + "attn.out_proj.bias"], tower["heads"], causal,
                      mm)
    h = F.layer_norm(x, (d,), p[pre + "ln_2.weight"], p[pre + "ln_2.bias"],
                     eps)
    h = act(mm(h, p[pre + "mlp.c_fc.weight"].t()) + p[pre + "mlp.c_fc.bias"])
    return (x + mm(h, p[pre + "mlp.c_proj.weight"].t())
            + p[pre + "mlp.c_proj.bias"])


def _eva_block(p: Params, pre: str, x: torch.Tensor, tower: Dict,
               mm: MatMul) -> torch.Tensor:
    eps, act = tower["ln_eps"], act_fn(tower["act"])
    d = x.shape[-1]
    q_bias, v_bias = p[pre + "attn.q_bias"], p[pre + "attn.v_bias"]
    b_qkv = torch.cat([q_bias, torch.zeros_like(q_bias), v_bias])
    h = F.layer_norm(x, (d,), p[pre + "norm1.weight"], p[pre + "norm1.bias"],
                     eps)
    x = x + attention(h, p[pre + "attn.qkv.weight"], b_qkv,
                      p[pre + "attn.proj.weight"], p[pre + "attn.proj.bias"],
                      tower["heads"], False, mm)
    h = F.layer_norm(x, (d,), p[pre + "norm2.weight"], p[pre + "norm2.bias"],
                     eps)
    h = act(mm(h, p[pre + "mlp.fc1.weight"].t()) + p[pre + "mlp.fc1.bias"])
    return (x + mm(h, p[pre + "mlp.fc2.weight"].t())
            + p[pre + "mlp.fc2.bias"])


def _patches(images: torch.Tensor, weight: torch.Tensor, bias, patch: int,
             mm: MatMul) -> torch.Tensor:
    """The stride-p conv (no overlap) as the product of each patch, in
    (cin, kh, kw) order, with the flattened kernel."""
    b, s, _, c = images.shape
    g = s // patch
    x = images[:, :g * patch, :g * patch].reshape(b, g, patch, g, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, c * patch * patch)
    x = mm(x, weight.reshape(weight.shape[0], -1).t())
    return x if bias is None else x + bias


def encode_image(p: Params, config: Dict, images: torch.Tensor,
                 mm: MatMul = torch.matmul) -> torch.Tensor:
    """[B, S, S, 3] -> L2-normalised [B, embed_dim]."""
    v = config["vision"]
    b = images.shape[0]
    if v["tower"] == "vit":
        x = _patches(images, p["visual.conv1.weight"], None, v["patch_size"],
                     mm)
        cls = p["visual.class_embedding"].expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + p["visual.positional_embedding"]
        w = x.shape[-1]
        x = F.layer_norm(x, (w,), p["visual.ln_pre.weight"],
                         p["visual.ln_pre.bias"], v["ln_eps"])
        for i in range(v["layers"]):
            x = _clip_block(p, f"visual.transformer.resblocks.{i}.", x, v,
                            False, mm)
        x = F.layer_norm(x[:, 0], (w,), p["visual.ln_post.weight"],
                         p["visual.ln_post.bias"], v["ln_eps"])
        x = mm(x, p["visual.proj"])
    elif v["tower"] == "eva01":
        t = "visual.trunk."
        x = _patches(images, p[t + "patch_embed.proj.weight"],
                     p[t + "patch_embed.proj.bias"], v["patch_size"], mm)
        x = torch.cat([p[t + "cls_token"].expand(b, -1, -1), x], dim=1)
        x = x + p[t + "pos_embed"]
        for i in range(v["layers"]):
            x = _eva_block(p, f"{t}blocks.{i}.", x, v, mm)
        w = x.shape[-1]
        x = F.layer_norm(x[:, 0], (w,), p[t + "norm.weight"],
                         p[t + "norm.bias"], v["ln_eps"])
        x = mm(x, p[t + "head.weight"].t()) + p[t + "head.bias"]
    else:
        raise ValueError(f"vision tower {v['tower']!r}")
    return F.normalize(x, dim=-1)


def encode_text(p: Params, config: Dict, ids: torch.Tensor,
                mm: MatMul = torch.matmul) -> torch.Tensor:
    """int [B, ctx] -> L2-normalised [B, embed_dim]."""
    t = config["text"]
    x = p["token_embedding.weight"][ids] + p["positional_embedding"]
    for i in range(t["layers"]):
        x = _clip_block(p, f"transformer.resblocks.{i}.", x, t, True, mm)
    x = F.layer_norm(x, (x.shape[-1],), p["ln_final.weight"],
                     p["ln_final.bias"], t["ln_eps"])
    pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(-1)]
    return F.normalize(mm(pooled, p["text_projection"]), dim=-1)


# -- parameter shapes ---------------------------------------------------------

# kinds: 'matrix' (fan-in^-1/2), 'branch_end' (fan-in^-1/2 x (2 L)^-1/2, the
# last layer of a residual branch), 'embed' (its own std), 'bias', 'ln_w',
# 'ln_b', 'scale' (the logit scale)
Spec = Tuple[str, Tuple[int, ...], str, float]


def _block_specs(pre: str, w: int, mlp: int, layers: int, eva: bool
                 ) -> List[Spec]:
    end = (w ** -0.5) * (2 * layers) ** -0.5
    end_mlp = (mlp ** -0.5) * (2 * layers) ** -0.5
    if eva:
        return [
            (pre + "norm1.weight", (w,), "ln_w", 0.0),
            (pre + "norm1.bias", (w,), "ln_b", 0.0),
            (pre + "attn.qkv.weight", (3 * w, w), "matrix", w ** -0.5),
            (pre + "attn.q_bias", (w,), "bias", 0.0),
            (pre + "attn.v_bias", (w,), "bias", 0.0),
            (pre + "attn.proj.weight", (w, w), "branch_end", end),
            (pre + "attn.proj.bias", (w,), "bias", 0.0),
            (pre + "norm2.weight", (w,), "ln_w", 0.0),
            (pre + "norm2.bias", (w,), "ln_b", 0.0),
            (pre + "mlp.fc1.weight", (mlp, w), "matrix", w ** -0.5),
            (pre + "mlp.fc1.bias", (mlp,), "bias", 0.0),
            (pre + "mlp.fc2.weight", (w, mlp), "branch_end", end_mlp),
            (pre + "mlp.fc2.bias", (w,), "bias", 0.0),
        ]
    return [
        (pre + "ln_1.weight", (w,), "ln_w", 0.0),
        (pre + "ln_1.bias", (w,), "ln_b", 0.0),
        (pre + "attn.in_proj_weight", (3 * w, w), "matrix", w ** -0.5),
        (pre + "attn.in_proj_bias", (3 * w,), "bias", 0.0),
        (pre + "attn.out_proj.weight", (w, w), "branch_end", end),
        (pre + "attn.out_proj.bias", (w,), "bias", 0.0),
        (pre + "ln_2.weight", (w,), "ln_w", 0.0),
        (pre + "ln_2.bias", (w,), "ln_b", 0.0),
        (pre + "mlp.c_fc.weight", (mlp, w), "matrix", w ** -0.5),
        (pre + "mlp.c_fc.bias", (mlp,), "bias", 0.0),
        (pre + "mlp.c_proj.weight", (w, mlp), "branch_end", end_mlp),
        (pre + "mlp.c_proj.bias", (w,), "bias", 0.0),
    ]


def param_specs(config: Dict) -> List[Spec]:
    """Every parameter of the CLIP of ``config``: (name, shape, kind,
    std), in the order the seeded weights are drawn."""
    v, t, e = config["vision"], config["text"], config["embed_dim"]
    w, p = v["width"], v["patch_size"]
    n = (v["image_size"] // p) ** 2 + 1
    specs: List[Spec] = []
    if v["tower"] == "vit":
        specs += [
            ("visual.conv1.weight", (w, 3, p, p), "matrix",
             (3 * p * p) ** -0.5),
            ("visual.class_embedding", (w,), "embed", w ** -0.5),
            ("visual.positional_embedding", (n, w), "embed", w ** -0.5),
            ("visual.ln_pre.weight", (w,), "ln_w", 0.0),
            ("visual.ln_pre.bias", (w,), "ln_b", 0.0),
        ]
        for i in range(v["layers"]):
            specs += _block_specs(f"visual.transformer.resblocks.{i}.", w,
                                  v["mlp_width"], v["layers"], False)
        specs += [
            ("visual.ln_post.weight", (w,), "ln_w", 0.0),
            ("visual.ln_post.bias", (w,), "ln_b", 0.0),
            ("visual.proj", (w, e), "matrix", w ** -0.5),
        ]
    elif v["tower"] == "eva01":
        tr = "visual.trunk."
        specs += [
            (tr + "patch_embed.proj.weight", (w, 3, p, p), "matrix",
             (3 * p * p) ** -0.5),
            (tr + "patch_embed.proj.bias", (w,), "bias", 0.0),
            (tr + "cls_token", (1, 1, w), "embed", 0.02),
            (tr + "pos_embed", (1, n, w), "embed", 0.02),
        ]
        for i in range(v["layers"]):
            specs += _block_specs(f"{tr}blocks.{i}.", w, v["mlp_width"],
                                  v["layers"], True)
        specs += [
            (tr + "norm.weight", (w,), "ln_w", 0.0),
            (tr + "norm.bias", (w,), "ln_b", 0.0),
            (tr + "head.weight", (e, w), "matrix", w ** -0.5),
            (tr + "head.bias", (e,), "bias", 0.0),
        ]
    else:
        raise ValueError(f"vision tower {v['tower']!r}")
    tw = t["width"]
    specs += [
        ("token_embedding.weight", (t["vocab_size"], tw), "embed", 0.02),
        ("positional_embedding", (t["context_length"], tw), "embed", 0.01),
    ]
    for i in range(t["layers"]):
        specs += _block_specs(f"transformer.resblocks.{i}.", tw,
                              t["mlp_width"], t["layers"], False)
    specs += [
        ("ln_final.weight", (tw,), "ln_w", 0.0),
        ("ln_final.bias", (tw,), "ln_b", 0.0),
        ("text_projection", (tw, e), "matrix", tw ** -0.5),
        ("logit_scale", (), "scale", 0.0),
    ]
    return specs
