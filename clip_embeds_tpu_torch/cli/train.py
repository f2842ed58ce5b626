"""Single-GPU contrastive training of CLIP (counterpart of
``clip_embeds_tpu/cli/train.py``; open_clip's ``training.main``).

fp32 master weights and AdamW state; the towers compute in ``--precision``
(bf16 by default). Blocks, in the JAX CLI's words: composable (default;
attention on the flash kernels' forward and backward for bf16 on the card),
``--fused-train-blocks`` (the fused-block kernels forward, the composable
block recomputed for the backward), ``--fused-train-blocks
--fused-train-backward residual`` (the backward recomputes through
``fused_block_residuals``). Off the card ``--fused-train-blocks`` warns and
keeps the composable blocks, as the JAX CLI does off the TPU.

  python -m clip_embeds_tpu_torch.cli.train --model ViT-L-14-336 \\
      --pretrained openai --dataset-type synthetic --batch-size 64 \\
      --train-num-samples 640 [--fused-train-blocks] [--device cpu]

The source's fine-tune recipe (open_clip ``train-clip.sh``) on LLaVA's
LCS-558K + DataMix-665K annotations, through the train augmentations:

  python -m clip_embeds_tpu_torch.cli.train --model ViT-L-14-336 \\
      --pretrained openai --lock-image --usehardtext \\
      --augfiles leftright.json --dataset-type datamix \\
      --train-data blip_laion_cc_sbu_558k.json llava_v1_5_mix665k.json \\
      --lcs-root LCS --datamix-root DATAMIX --batch-size 256

``--dataset-type csv|webdataset|auto`` read a TSV or tar shards the same
way; ``--force-patch-dropout p`` turns on FLIP patch dropout.

The flags of the JAX CLI that are not ported yet exit with an error that
names the ROADMAP.md item that will port them; none is parsed and ignored.
``main(argv)`` returns the :class:`~..train.steps.TrainState`.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# JAX flags that this CLI does not take yet, by the ROADMAP.md item that
# will port them
_EXTRAS = "queue 1 item 5g (async checkpoints, logging, remote sync)"
_UNPORTED_ITEMS = {
    "queue 1 item 5c (distill and CoCa steps)": (
        "--distill-model", "--distill-pretrained",
        "--coca-caption-loss-weight", "--coca-contrastive-loss-weight"),
    "queue 1 item 5f (validation and zero-shot in training)": (
        "--val-data", "--val-frequency", "--val-num-samples",
        "--imagenet-val", "--zeroshot-frequency"),
    "queue 1 item 6 (multi-GPU)": ("--fsdp",),
    _EXTRAS: ("--async-checkpoints", "--remote-sync",
              "--remote-sync-frequency", "--remote-sync-protocol",
              "--report-to", "--logs", "--name"),
}
_UNPORTED = {flag: item for item, flags in _UNPORTED_ITEMS.items()
             for flag in flags}


class ParseKwargs(argparse.Action):
    """key=value list -> dict with literal-eval values (the JAX CLI's
    ``ParseKwargs``, open_clip's ``params.py``; used by --aug-cfg)."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, value = value.split("=", 1)
            try:
                kw[key] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                kw[key] = str(value)
        setattr(namespace, self.dest, kw)


def build_train_transform(args, model_cfg):
    """RandomResizedCrop(+aug_cfg) train transform at the model's image
    size (open_clip's ``preprocess_train``), or None with
    ``--no-train-aug`` (the deterministic eval transform)."""
    if args.no_train_aug:
        return None
    from ..image.transform import image_transform

    return image_transform(model_cfg.vision.image_size, is_train=True,
                           aug_cfg=args.aug_cfg or None)


def parse_args(argv=None):
    p = argparse.ArgumentParser("clip_embeds_tpu_torch trainer")
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--force-quick-gelu", action="store_true")
    p.add_argument("--batch-size", type=int, default=64, help="global batch")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--train-num-samples", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-6)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.98)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--wd", type=float, default=0.1)
    p.add_argument("--warmup", type=int, default=140)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--lr-scheduler", default="cosine",
                   choices=["cosine", "const", "const-cooldown"])
    p.add_argument("--epochs-cooldown", type=int, default=None,
                   help="const-cooldown: cooldown over the last N epochs")
    p.add_argument("--lr-cooldown-end", type=float, default=0.0)
    p.add_argument("--lr-cooldown-power", type=float, default=1.0)
    p.add_argument("--lock-image", action="store_true",
                   help="LiT: freeze the vision tower")
    p.add_argument("--lock-image-unlocked-groups", type=int, default=0)
    p.add_argument("--lock-text", action="store_true")
    p.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    p.add_argument("--lock-text-freeze-layer-norm", action="store_true")
    p.add_argument("--usehardtext", action="store_true")
    p.add_argument("--augfiles", nargs="*", default=None,
                   help="hard-negative swap tables (JSON), merged")
    p.add_argument("--aug-cfg", nargs="*", default={}, action=ParseKwargs,
                   help="train-augmentation key=value pairs "
                        "(image/transform.py AugmentationCfg), e.g. "
                        "scale='(0.8,1.0)' color_jitter='(0.4,0.4,0.4,0.1)' "
                        "color_jitter_prob=0.8 gray_scale_prob=0.2")
    p.add_argument("--no-train-aug", action="store_true",
                   help="train on the deterministic eval transform instead "
                        "of RandomResizedCrop (an ablation)")
    p.add_argument("--force-patch-dropout", type=float, default=None,
                   help="FLIP patch dropout: the share of patch tokens the "
                        "image tower drops in training")
    p.add_argument("--siglip", action="store_true",
                   help="the sigmoid loss (losses/siglip.py) in place of "
                        "InfoNCE")
    p.add_argument("--grad-cache-chunks", type=int, default=0)
    p.add_argument("--accum-freq", type=int, default=1,
                   help="gradient accumulation; maps to the exact-gradient "
                        "grad-cache")
    p.add_argument("--grad-checkpointing", action="store_true")
    p.add_argument("--grad-checkpointing-policy", default="full",
                   choices=["full", "dots", "attn"],
                   help="'dots' keeps the projections' outputs resident, "
                        "'attn' the attention branch's output")
    p.add_argument("--fused-train-blocks", action="store_true",
                   help="blocks through the fused-block kernels, with a "
                        "custom backward (ops/fused_block_ad.py); on the "
                        "card, in bf16")
    p.add_argument("--fused-train-backward", default="vjp",
                   choices=["residual", "vjp"],
                   help="with --fused-train-blocks: 'residual' recomputes "
                        "through fused_block_residuals, 'vjp' recomputes "
                        "the composable block")
    p.add_argument("--dataset-type", default="synthetic",
                   choices=["synthetic", "datamix", "csv", "webdataset",
                            "auto"])
    p.add_argument("--train-data", nargs="*", default=None,
                   help="datamix annotation JSONs / a CSV or TSV file / "
                        "tar shard URLs with {000..127} brace expansion")
    p.add_argument("--csv-img-key", default="filepath")
    p.add_argument("--csv-caption-key", default="title")
    p.add_argument("--csv-separator", default="\t")
    p.add_argument("--dataset-resampled", action="store_true",
                   help="webdataset: draw shards with replacement")
    p.add_argument("--train-data-upsampling-factors", default=None,
                   help="webdataset: '::'-separated per-URL weights")
    p.add_argument("--wds-shuffle-buffer", type=int, default=5000,
                   help="webdataset sample shuffle buffer")
    p.add_argument("--lcs-root", default=None,
                   help="datamix: the LCS-558K image root (paths that "
                        "start with '0')")
    p.add_argument("--datamix-root", default=None,
                   help="datamix: the DataMix-665K image root")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", default=None, help="'latest' or a path")
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--save-most-recent", action="store_true")
    p.add_argument("--delete-previous-checkpoint", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: exits if there is no card) "
                        "or 'cpu'")
    for flag, item in _UNPORTED.items():
        p.add_argument(flag, nargs="*", default=argparse.SUPPRESS,
                       help=f"not ported yet: ROADMAP.md {item}")
    args = p.parse_args(argv)
    for flag, item in _UNPORTED.items():
        if hasattr(args, flag[2:].replace("-", "_")):
            p.error(f"{flag} is not ported yet: ROADMAP.md {item}")
    return args


def build_data(args, model_cfg, epoch: int = 0
               ) -> Tuple[Iterator[Dict[str, np.ndarray]], int]:
    """(epoch ``epoch``'s batches, steps an epoch), as the JAX CLI's
    ``build_data``: CSV and datamix take ``len(dataset) // batch_size``
    steps, webdataset and synthetic ``--train-num-samples //
    batch_size``; ``auto`` picks CSV or webdataset by the first file's
    extension."""
    from ..text.tokenizer import get_tokenizer

    dataset_type = args.dataset_type
    if dataset_type == "auto":
        ext = args.train_data[0].split(".")[-1]
        if ext in ("csv", "tsv"):
            dataset_type = "csv"
        elif ext == "tar":
            dataset_type = "webdataset"
        else:
            raise ValueError(
                f"cannot infer dataset type from extension {ext!r}")
    tokenizer = get_tokenizer(model_cfg.text.context_length)
    if dataset_type == "csv":
        from ..data.csv_dataset import CsvPairDataset, csv_batches

        ds = CsvPairDataset(
            args.train_data[0], img_key=args.csv_img_key,
            caption_key=args.csv_caption_key, sep=args.csv_separator,
        )
        return csv_batches(
            ds, args.batch_size, model_cfg.vision.image_size, tokenizer,
            epoch=epoch, seed=args.seed,
            train_transform=build_train_transform(args, model_cfg),
        ), len(ds) // args.batch_size
    if dataset_type == "webdataset":
        from ..data.wds import (
            ShardedTarDataset, decode_raw_image_text, wds_batches)

        weights = None
        if args.train_data_upsampling_factors:
            weights = [float(w) for w in
                       args.train_data_upsampling_factors.split("::")]
        ds = ShardedTarDataset(
            args.train_data if len(args.train_data) > 1
            else args.train_data[0],
            decode=decode_raw_image_text, seed=args.seed,
            resampled=args.dataset_resampled, weights=weights,
            sample_shuffle_size=args.wds_shuffle_buffer,
        )
        return wds_batches(
            ds, args.batch_size, image_size=model_cfg.vision.image_size,
            tokenizer=tokenizer, epoch=epoch, seed=args.seed,
            train_transform=build_train_transform(args, model_cfg),
        ), max(args.train_num_samples // args.batch_size, 1)
    if dataset_type == "synthetic":
        from ..data.synthetic import synthetic_batches

        steps = max(args.train_num_samples // args.batch_size, 1)
        return synthetic_batches(
            args.batch_size, model_cfg.vision.image_size,
            model_cfg.text.context_length, num_batches=steps,
            hard_negatives=args.batch_size // 4 if args.usehardtext else 0,
            seed=args.seed,
        ), steps
    from ..data.datamix import DataMixDataset, datamix_batches
    from ..data.hard_negatives import HardNegativeAugmenter, \
        leftright_augmenter

    aug = None
    if args.usehardtext:
        aug = (HardNegativeAugmenter(augfiles=args.augfiles) if args.augfiles
               else leftright_augmenter(args.seed))
    ds = DataMixDataset(
        args.train_data,
        {"lcs558k": args.lcs_root, "datamix665k": args.datamix_root},
        image_size=model_cfg.vision.image_size, tokenizer=tokenizer,
        augmenter=aug, seed=args.seed,
        train_transform=build_train_transform(args, model_cfg),
    )
    return datamix_batches(
        ds, args.batch_size,
        max_hard_per_batch=args.batch_size // 4 if args.usehardtext else 0,
        seed=args.seed, epoch=epoch,
    ), len(ds) // args.batch_size


def _block_impl(args, device: torch.device, dtype: torch.dtype, cfg) -> str:
    """The block route: fused only on the card, where the kernels take the
    shapes the blocks will see (in bf16, the kernels' type): the image
    tower's 1 + kept patches under patch dropout, else 1 + all."""
    if not args.fused_train_blocks:
        return "composable"
    if device.type != "cuda":
        logging.warning("--fused-train-blocks needs the card; keeping "
                        "composable blocks")
        return "composable"
    from ..models.vit import patches_kept
    from ..ops.fused_block import fused_block_supported

    if dtype != torch.bfloat16:
        raise SystemExit("--fused-train-blocks runs the bf16 fused-block "
                         "kernels; --precision fp32 cannot take them")
    v, t = cfg.vision, cfg.text
    drop = (v.patch_dropout if args.force_patch_dropout is None
            else args.force_patch_dropout)
    rows = 1 + patches_kept(v.num_patches, drop)
    if not (fused_block_supported(rows, v.width, v.heads, v.mlp_ratio)
            and fused_block_supported(t.context_length, t.width, t.heads,
                                      t.mlp_ratio)):
        raise SystemExit(f"--fused-train-blocks: the fused-block kernels do "
                         f"not take the shapes of {args.model}")
    return ("fused-train-res" if args.fused_train_backward == "residual"
            else "fused-train")


def _to_device(batch: Dict[str, np.ndarray], device: torch.device):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ..core import checkpoint as ckpt
    from ..core.factory import create_model, resolve_device
    from ..core.config import get_model_config
    from ..train.freeze import apply_freeze, tower_freeze_labels
    from ..train.optim import adamw
    from ..train.schedules import const_lr, const_lr_cooldown, cosine_lr
    from ..train.steps import TrainState, make_clip_train_step

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    remat = args.grad_checkpointing and (
        args.grad_checkpointing_policy
        if args.grad_checkpointing_policy in ("dots", "attn") else True)
    cfg = get_model_config(args.model, args.pretrained)
    block_impl = _block_impl(args, device, dtype, cfg)
    if block_impl != "composable":
        # the fused blocks keep only (x, params) per block already
        remat = False
    model = create_model(
        args.model, args.pretrained, seed=args.seed, dtype=torch.float32,
        device=device, remat=remat, block_impl=block_impl,
        compute_dtype=dtype, force_quick_gelu=args.force_quick_gelu,
        force_patch_dropout=args.force_patch_dropout, train=True)
    data_iter, steps_per_epoch = build_data(args, model.cfg)
    total_steps = steps_per_epoch * args.epochs

    if args.lr_scheduler == "cosine":
        sched = cosine_lr(args.lr, args.warmup, total_steps)
    elif args.lr_scheduler == "const-cooldown":
        cooldown_steps = steps_per_epoch * (
            args.epochs_cooldown if args.epochs_cooldown else args.epochs)
        sched = const_lr_cooldown(
            args.lr, args.warmup, total_steps, cooldown_steps,
            args.lr_cooldown_power, args.lr_cooldown_end)
    else:
        sched = const_lr(args.lr, args.warmup)
    if args.accum_freq > 1 and args.grad_cache_chunks <= 1:
        # open_clip's --accum-freq cached-feature replay is the grad-cache
        # algorithm: exact gradients of the full accumulated batch
        args.grad_cache_chunks = args.accum_freq
    if args.grad_cache_chunks > 1 and (args.siglip or args.usehardtext):
        raise SystemExit("--accum-freq/--grad-cache-chunks supports the "
                         "InfoNCE objective only (the cached-replay loss is "
                         "clip_loss); drop --siglip/--usehardtext or the "
                         "accumulation")
    if args.grad_cache_chunks > 1 and args.force_patch_dropout:
        logging.warning("patch dropout is disabled on the grad-cache path "
                        "(the cached encode pass runs deterministically)")

    if args.lock_image or args.lock_text:
        apply_freeze(model, tower_freeze_labels(
            model, model.cfg, lock_image=args.lock_image,
            lock_image_unlocked_groups=args.lock_image_unlocked_groups,
            lock_text=args.lock_text,
            lock_text_unlocked_layers=args.lock_text_unlocked_layers,
            lock_text_freeze_layer_norm=args.lock_text_freeze_layer_norm))
    state = TrainState(model, adamw(model, args.lr, args.beta1, args.beta2,
                                    args.eps, args.wd),
                       sched, args.grad_clip_norm)

    start_epoch = 0
    if args.resume and args.checkpoint_dir:
        restored = (ckpt.resume(args.checkpoint_dir)
                    if args.resume == "latest" else ckpt.load(args.resume))
        if restored is not None:
            with torch.no_grad():
                model.load_state_dict(restored["state_dict"])
            start_epoch = int(restored["step"])
            logging.info("resumed at epoch %d", start_epoch)

    step_fn = make_clip_train_step(model, use_hard_text=args.usehardtext,
                                   grad_cache_chunks=args.grad_cache_chunks,
                                   use_siglip=args.siglip, seed=args.seed)
    prev_ckpt_step = None
    logging.info("device=%s blocks=%s steps/epoch=%d", device, block_impl,
                 steps_per_epoch)
    for epoch in range(start_epoch, args.epochs):
        if epoch > start_epoch or epoch > 0:
            data_iter, _ = build_data(args, model.cfg, epoch=epoch)
        t0 = time.perf_counter()
        seen = 0
        for i, batch in enumerate(data_iter):
            metrics = step_fn(state, _to_device(batch, device))
            seen += args.batch_size
            if (i + 1) % args.log_every == 0 or i + 1 == steps_per_epoch:
                loss = float(metrics["loss"])  # waits for the device
                dt = time.perf_counter() - t0
                logging.info(
                    "epoch %d step %d loss %.4f lr %.2e "
                    "samples/s %.1f samples/s/chip %.1f",
                    epoch, i + 1, loss, sched(state.step), seen / dt,
                    seen / dt)
        done = epoch + 1
        if args.checkpoint_dir and (
                (args.save_frequency > 0 and done % args.save_frequency == 0)
                or done == args.epochs or args.save_most_recent):
            sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            ckpt.save(args.checkpoint_dir, {"state_dict": sd, "step": done},
                      step=done)
            # --delete-previous-checkpoint, or the transient
            # --save-most-recent copy
            if prev_ckpt_step is not None and (
                    args.delete_previous_checkpoint
                    or (args.save_most_recent
                        and (args.save_frequency <= 0
                             or prev_ckpt_step % args.save_frequency != 0))):
                old = os.path.join(args.checkpoint_dir,
                                   f"{ckpt.CKPT_PREFIX}{prev_ckpt_step}.pt")
                if os.path.exists(old):
                    os.remove(old)
            prev_ckpt_step = done
    logging.info("done: %d steps", state.step)
    return state


if __name__ == "__main__":
    main()
