#!/usr/bin/env python3
"""chip_smoke.py's phase 19 (multi-GPU at one rank) alone, on one NVIDIA
GPU, with the readings behind its limits:

    python3 scripts/chip_probe_parallel.py

ViT-L/14-336 (OpenAI config) with chip_smoke.py's seed-0 weights. First
the plain fused-train-res route as phase 6 runs it (cli/train.py main,
TRAIN_STEPS steps at TRAIN_BATCH: the losses; the b32 step's samples/s by
CUDA events and its peak), then chip_smoke.check_multi_gpu on those:
--fsdp and DDP through the CLI in a one-rank NCCL group (each run's
losses against the plain run's, the max |diff| that MULTI_LOSS_TOL sits
above), the checkpoint round trip, FSDP and DDP samples/s and peaks, the
gathered losses at one rank and cli/embed.py --data-parallel. Exits with
code 2 without a CUDA device.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def plain_losses(counters):
    """The plain fused-train-res CLI run's losses (phase 6's)."""
    from clip_embeds_tpu_torch.cli.train import main as train_main

    log = cs._StepLog()
    logging.getLogger().addHandler(log)
    try:
        train_main(["--model", cs.MODEL, "--pretrained", "openai", "--seed",
                    "0", "--batch-size", str(cs.TRAIN_BATCH),
                    "--train-num-samples",
                    str(cs.TRAIN_STEPS * cs.TRAIN_BATCH), "--lr", "1e-5",
                    "--warmup", "1", "--log-every", "1",
                    *cs.ROUTES["fused-train-res"][0]])
    finally:
        logging.getLogger().removeHandler(log)
    return list(log.losses)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.ops import _build
    from clip_embeds_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_int8, fused_block_residuals)

    gpu = cs.gpu_line()
    print(f"[probe] {gpu} | torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    logging.getLogger().setLevel(logging.INFO)
    counters = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "fused_block": fused_block,
                "fused_block_residuals": fused_block_residuals,
                "fused_block_int8": fused_block_int8}
    base = {k: v.detach().cpu() for k, v in
            cs.route_model("composable").state_dict().items()}
    with cs.seeded_from(base):
        losses = plain_losses(counters)
        print(f"[probe] plain fused-train-res losses {losses}")
        rate, peak = cs.multi_step_rate(gpu, None)
        t0 = time.perf_counter()
        cs.check_multi_gpu(
            counters, gpu, {("fused-train-res", cs.TRAIN_BATCH): rate},
            {"losses": {"fused-train-res": losses},
             "peaks": {("fused-train-res", cs.TRAIN_BATCH): peak}})
        print(f"[phase 19] {time.perf_counter() - t0:.1f} s on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
