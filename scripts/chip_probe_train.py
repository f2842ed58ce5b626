#!/usr/bin/env python3
"""Fault probes behind the limits of chip_smoke.py's training checks, on
one NVIDIA GPU:

    python3 scripts/chip_probe_train.py

For each check it prints the sound reading (kernel against its plain
version) beside readings of faults a limit must catch, each read as the
plain version with the fault against the plain version:

  flash_attention_bwd (chip_smoke.FLASH_CASES), mean |diff| of the worst
      of dq, dk, dv: the delta term dropped; the contribution of one 64-row
      Q tile to dK and dV dropped; the causal mask left out of the backward
      (causal shapes only);
  fused_block_residuals (chip_smoke.BLOCK_CASES), mean |diff| of the worst
      of its five outputs: m1 stored after the activation; and fused_block
      at the same shapes: the out-projection bias dropped;
  training gradients at batch 8 (ViT-L/14-336, bf16) against the plain
      fp32 composable path: cosine over all gradients and the least
      per-tensor cosine, for the witness (the bf16 composable model with
      plain attention, no kernel), each sound block route, the composable
      and residual routes with the attention backward's delta term dropped,
      and the residual route with m1 stored after the activation.

Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def bwd_delta_dropped(q, k, v, o, do, causal=False):
    """The plain backward with delta = rowsum(dO * O) taken as 0: O = 0 is
    what it reads O for."""
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference)

    return flash_attention_bwd_reference(q, k, v, torch.zeros_like(o), do,
                                         causal)


def bwd_q_tile_dropped(q, k, v, o, do, causal=False, tile=1):
    """The plain backward with the rows of one 64-row Q tile left out of dK
    and dV: their dO zeroed, which zeroes their dS and P^T dO terms."""
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference)

    dq = flash_attention_bwd_reference(q, k, v, o, do, causal)[0]
    do = do.clone()
    do[..., 64 * tile:64 * (tile + 1), :] = 0
    return (dq, *flash_attention_bwd_reference(q, k, v, o, do, causal)[1:])


def m1_after_activation(real):
    """_fused_block_residuals whose m1 is stored after the activation."""
    from clip_embeds_tpu_torch.ops.fused_block import _apply_act

    def fn(args, heads, kv_valid, *a, **kw):
        out = list(real(args, heads, kv_valid, *a, **kw))
        out[3] = _apply_act(out[3].float(), kw["act"]).to(out[3].dtype)
        return tuple(out)
    return fn


def worst_mean(got, want, rows=None):
    return max(float((a.float() - w.float())[:, :rows].abs().mean())
               for a, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe_train: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.ops import flash_attention as fa
    from clip_embeds_tpu_torch.ops import fused_block_ad
    from clip_embeds_tpu_torch.ops.fused_block import (
        _apply_act, fused_block, fused_block_reference, fused_block_residuals,
        fused_block_residuals_reference)

    gpu = cs.gpu_line()
    print(f"[device] {gpu}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for shape, causal, _ in cs.FLASH_CASES:
            q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to("cuda", torch.bfloat16) for _ in range(4))
            o, lse = fa._flash_forward(q, k, v, causal, with_lse=True)
            plain = fa.flash_attention_bwd_reference(q, k, v, o, g, causal)
            row = {
                "sound": worst_mean(
                    fa.flash_attention_bwd(q, k, v, o, g, lse, causal),
                    plain),
                "delta dropped": worst_mean(
                    bwd_delta_dropped(q, k, v, o, g, causal), plain),
                "Q tile 1 dropped from dK/dV": worst_mean(
                    bwd_q_tile_dropped(q, k, v, o, g, causal), plain),
            }
            if causal:
                row["causal mask left out"] = worst_mean(
                    fa.flash_attention_bwd_reference(q, k, v, o, g, False),
                    plain)
            print(f"[probe] flash_attention_bwd {'x'.join(map(str, shape))} "
                  f"causal={causal} mean|diff|: {row} on {gpu}")
            del q, k, v, g, o, lse, plain

        for (b, n, d, heads, kv, causal), *_ in cs.BLOCK_CASES:
            args = cs.block_inputs(rng, b, n, d, 4 * d)
            kw = dict(heads=heads, kv_valid=kv, quick_gelu=True,
                      causal=causal)
            plain = fused_block_reference(*args, **kw)
            no_bo = list(args)
            no_bo[4] = torch.zeros_like(args[4])
            row = {"sound": worst_mean([fused_block(*args, **kw)], [plain],
                                       kv),
                   "out-projection bias dropped": worst_mean(
                       [fused_block_reference(*no_bo, **kw)], [plain], kv)}
            print(f"[probe] fused_block {b}x{n}x{d} causal={causal} "
                  f"mean|diff|: {row} on {gpu}")
            plain = fused_block_residuals_reference(*args, **kw)
            fault = list(plain)
            fault[3] = _apply_act(plain[3].float(), "quick").to(
                plain[3].dtype)
            row = {"sound": worst_mean(fused_block_residuals(*args, **kw),
                                       plain, kv),
                   "m1 stored after the activation": worst_mean(fault, plain,
                                                                kv)}
            print(f"[probe] fused_block_residuals {b}x{n}x{d} "
                  f"causal={causal} mean|diff|: {row} on {gpu}")
            del args, plain, fault, no_bo

    batch = cs.train_batch(cs.GRAD_BATCH, seed=1)
    ref, _ = cs.train_grads(cs.route_model("composable", compute_dtype=None),
                            batch)

    def read(label, route, witness=None):
        """Prints (cosine, least per-tensor cosine, its tensor) of one
        route's gradients against the fp32 path and against the witness."""
        grads = cs.train_grads(cs.route_model(route), batch)[0]
        against = "" if witness is None else (
            f", vs the witness {cs.grad_agreement(grads, witness)}")
        print(f"[probe] gradients at batch {cs.GRAD_BATCH}: {label} vs "
              f"plain fp32 {cs.grad_agreement(grads, ref)}{against} on {gpu}")
        return grads

    with cs.plain_attention():
        witness = read("witness (bf16 composable, plain attention)",
                       "composable")
    read = functools.partial(read, witness=witness)
    for route in cs.ROUTES:
        read(f"{route} sound", route)
    drop = lambda q, k, v, o, do, lse, causal=False: bwd_delta_dropped(
        q, k, v, o, do, causal)
    with cs.patched(fa, "flash_attention_bwd", drop):
        read("composable, delta dropped", "composable")
    with cs.patched(fused_block_ad, "flash_attention_bwd", drop):
        read("fused-train-res, delta dropped", "fused-train-res")
    with cs.patched(fused_block_ad, "_fused_block_residuals",
                    m1_after_activation(
                        fused_block_ad._fused_block_residuals)):
        read("fused-train-res, m1 stored after the activation",
             "fused-train-res")
    return 0


if __name__ == "__main__":
    sys.exit(main())
