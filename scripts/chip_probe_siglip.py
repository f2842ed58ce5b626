#!/usr/bin/env python3
"""Fault probes behind the limits of chip_smoke.py's SigLIP checks (phase 3,
head dim 72), on one NVIDIA GPU:

    python3 scripts/chip_probe_siglip.py

A head dim of 72 runs on the attention kernel's 128-wide tile with its
tensor maps ending at 72 columns. Two faults of that design are probed,
each read as the plain version with the fault against the plain version
(mean |diff| over the valid rows), beside the sound reading (kernel
against its plain version):

  scale: the logits scaled by 1/sqrt(128), the tile's head dim, instead of
      1/sqrt(72);
  columns: the tile's 56 padded columns of q and k read from memory
      instead of zero-filled (in the packed [B, n, 3d] buffer, the next
      head's first 56 columns; in a contiguous [B, H, N, 72] tensor, the
      next row's first 56 values).

At chip_smoke.SIGLIP_BLOCK_CASES for fused_block and fused_block_int8 (the
fault in the block's attention) and chip_smoke.SIGLIP_FLASH_CASES for the
attention forward. Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

TILE = 128  # the attention kernel's tile head dim for 64 < hd <= 128


def _extended(flat, shape, strides, offset):
    """[..., TILE] views of ``flat`` (zero-padded past its end) from
    ``offset``: each row's hd values and the TILE - hd that follow."""
    flat = F.pad(flat, (0, TILE))
    return flat.as_strided(shape, strides, offset)


def _softmax_pv(s, v, keep, dt):
    """The plain versions' P.V: fp32 logits, P rounded to ``dt``."""
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return torch.matmul(p.to(dt).float(), v.float()) / p.sum(-1, keepdim=True)


def faulty_packed_attention(fault):
    """ops/fused_block._attention_reference with ``fault``."""
    def attention(qkv, heads, kv_valid, causal):
        dt = qkv.dtype
        b, n, d3 = qkv.shape
        d = d3 // 3
        hd = d // heads
        q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        scale = hd ** -0.5
        if fault == "scale":
            scale = TILE ** -0.5
        else:  # head g's columns g*hd .. g*hd + 127 of the packed row
            flat = qkv.reshape(b, n * d3)
            strides = (n * d3 + TILE, hd, d3, 1)
            q, k = (_extended(flat, (b, heads, n, TILE), strides, off)
                    for off in (0, d))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        col = torch.arange(n, device=qkv.device)
        keep = (col < kv_valid)[None, :]
        if causal:
            keep = keep & (col[None, :] <= col[:, None])
        att = _softmax_pv(s, v, keep, dt)
        return att.to(dt).transpose(1, 2).reshape(b, n, d)
    return attention


def faulty_flash(fault, q, k, v):
    """flash_attention_reference (non-causal) with ``fault`` on contiguous
    [B, H, N, hd] tensors."""
    b, h, n, hd = q.shape
    scale = hd ** -0.5
    if fault == "scale":
        scale = TILE ** -0.5
    else:
        q, k = (_extended(t.reshape(b * h, n * hd), (b * h, n, TILE),
                          (n * hd + TILE, hd, 1), 0).view(b, h, n, TILE)
                for t in (q, k))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device)
    return _softmax_pv(s, v, keep, v.dtype).to(v.dtype)


def mean_diff(a, b, rows=None):
    """Mean |a - b|, over the first ``rows`` rows (axis 1) if given."""
    diff = (a.float() - b.float()).abs()
    return float((diff if rows is None else diff[:, :rows]).mean())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_siglip: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.ops import fused_block as fb
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    gpu = cs.gpu_line()
    print(f"[device] {gpu}")
    rng = np.random.default_rng(9)  # chip_smoke's SigLIP generator
    with torch.inference_mode():
        for (b, n, d, heads, kv, causal), *_ in cs.SIGLIP_BLOCK_CASES:
            args = cs.block_inputs(rng, b, n, d, cs.SIGLIP_MLP)
            args8 = cs.int8_block_inputs(args, heads, kv, causal, "tanh",
                                         cs.SIGLIP_EPS)
            kw = dict(heads=heads, kv_valid=kv, act="tanh",
                      ln_eps=cs.SIGLIP_EPS, causal=causal)
            for name, kernel, plain, a in (
                    ("fused_block", fb.fused_block, fb.fused_block_reference,
                     args),
                    ("fused_block_int8", fb.fused_block_int8,
                     fb.fused_block_int8_reference, args8)):
                want = plain(*a, **kw)
                row = {"sound": mean_diff(kernel(*a, **kw), want, kv)}
                for fault in ("scale", "columns"):
                    with cs.patched(fb, "_attention_reference",
                                    faulty_packed_attention(fault)):
                        row[fault] = mean_diff(plain(*a, **kw), want, kv)
                print(f"[probe] {name} {b}x{n}x{d} hd {d // heads}: "
                      + ", ".join(f"{k} {v:.3g}" for k, v in row.items())
                      + f" on {gpu}")
        for shape, causal, _ in cs.SIGLIP_FLASH_CASES:
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
            want = flash_attention_reference(q, k, v, causal)
            row = {"sound": mean_diff(flash_attention(q, k, v, causal),
                                      want)}
            for fault in ("scale", "columns"):
                row[fault] = mean_diff(faulty_flash(fault, q, k, v), want)
            print(f"[probe] flash_attention {'x'.join(map(str, shape))}: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in row.items())
                  + f" on {gpu}")
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
