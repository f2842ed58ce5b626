"""Contrastive training of CLIP on one card or many (counterpart of
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

At each epoch's end, in the JAX CLI's order: validation on ``--val-data``
(a CSV/TSV or tar shards; retrieval recall and ``clip_val_loss`` over the
first ``--val-num-samples``), ImageNet zero-shot on the ImageFolder root
``--imagenet-val`` (the 1000 classnames and OpenAI's 80 templates), the
checkpoint (``--async-checkpoints`` writes it on a thread) and the prune.
The evals run the training route's blocks without patch dropout and
without gradients. ``--report-to jsonl,tensorboard,wandb --logs DIR
--name RUN`` append each eval's line to ``DIR/RUN/results.jsonl`` (and the
sinks that import); ``--remote-sync DEST`` mirrors ``--checkpoint-dir``
every ``--remote-sync-frequency`` seconds and once at the end.
``--distill-model M --distill-pretrained TAG_OR_PATH`` adds open_clip's
distillation loss from that frozen teacher:

  python -m clip_embeds_tpu_torch.cli.train --model ViT-L-14-336 \\
      --pretrained openai --dataset-type csv --train-data train.tsv \\
      --val-data val.tsv --imagenet-val IMAGENET/val \\
      --distill-model ViT-L-14-336 --distill-pretrained teacher.pt \\
      --checkpoint-dir ckpt --async-checkpoints --remote-sync /mnt/mirror \\
      --report-to jsonl --logs logs --name run1

Many cards: one process a card under ``torchrun``, each rank training its
contiguous slice of every global batch (``--batch-size`` is global, as in
JAX, and must divide by the ranks) through ``DistributedDataParallel``, or
with ``--fsdp`` through FSDP2 with JAX's ``fsdp_param_specs``
(``parallel/sharding_rules.py``); the losses gather the features, so the
gradients are the global batch's. ``--fsdp`` without ``torchrun`` trains
in a one-rank group. Rank 0 alone logs, writes ``results.jsonl`` and the
checkpoints (whole, from every rank's shards) and runs the mirror:

  torchrun --nproc-per-node 8 -m clip_embeds_tpu_torch.cli.train \
      --model ViT-L-14-336 --batch-size 256 [--fsdp] ...

A registry CoCa (``--model coca_ViT-L-14``) trains with CoCa's step:
the contrastive loss at ``--coca-contrastive-loss-weight`` plus the
caption loss at ``--coca-caption-loss-weight``, on composable blocks:

  python -m clip_embeds_tpu_torch.cli.train --model coca_ViT-L-14 \
      --dataset-type synthetic --batch-size 32 --train-num-samples 96 \
      --coca-caption-loss-weight 2.0 --coca-contrastive-loss-weight 1.0

Every 'clip' name of the registry trains (``--model EVA01-g-14``, ``RN50``,
``convnext_xxlarge``, ``MobileCLIP-S2``, ...): its zoo vision tower on
composable blocks, the text tower on the route the flags pick, as JAX's
``block_impl`` reaches only the text tower. ``--force-patch-dropout`` and
``--lock-image-unlocked-groups``, which the JAX CLI applies to the ViT alone,
exit on a zoo tower; an hf-text name raises JAX's NotImplementedError.

The flags that a route's step would drop exit before the first step,
naming the flag, where the JAX CLI runs on without them: with
distillation ``--siglip``, ``--usehardtext`` and ``--grad-cache-chunks`` /
``--accum-freq`` above 1; with a CoCa those, ``--force-patch-dropout``,
``--fused-train-blocks``, ``--grad-checkpointing`` and the distillation
flags. ``main(argv)`` returns the :class:`~..train.steps.TrainState`.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


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
    p.add_argument("--distill-model", default=None,
                   help="the teacher's architecture to distill from "
                        "(with --distill-pretrained)")
    p.add_argument("--distill-pretrained", default=None,
                   help="the teacher's weights: a tag or a state-dict path")
    p.add_argument("--coca-caption-loss-weight", type=float, default=2.0)
    p.add_argument("--coca-contrastive-loss-weight", type=float,
                   default=1.0)
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
    p.add_argument("--fsdp", action="store_true",
                   help="fully shard the parameters over the ranks "
                        "(parallel/sharding_rules.py fsdp_param_specs; "
                        "FSDP2, the same math); without torchrun, a "
                        "one-rank group")
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
    p.add_argument("--val-data", default=None,
                   help="a CSV/TSV file or tar shards of held-out pairs")
    p.add_argument("--val-frequency", type=int, default=1)
    p.add_argument("--val-num-samples", type=int, default=512)
    p.add_argument("--imagenet-val", default=None,
                   help="an ImageFolder root of ImageNet val for zero-shot")
    p.add_argument("--zeroshot-frequency", type=int, default=2)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", default=None, help="'latest' or a path")
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--save-most-recent", action="store_true")
    p.add_argument("--delete-previous-checkpoint", action="store_true")
    p.add_argument("--async-checkpoints", action="store_true",
                   help="write each checkpoint on a thread while the next "
                        "epoch runs")
    p.add_argument("--remote-sync", default=None,
                   help="a directory (or s3:// / gs:// URL) to mirror "
                        "--checkpoint-dir to")
    p.add_argument("--remote-sync-frequency", type=int, default=300,
                   help="seconds between mirror passes")
    p.add_argument("--remote-sync-protocol", default="s3",
                   choices=["s3", "fsspec"],
                   help="taken for the JAX CLI's sake: the destination's "
                        "prefix picks the tool")
    p.add_argument("--report-to", default="",
                   help="comma list: jsonl,tensorboard,wandb")
    p.add_argument("--logs", default=None,
                   help="log root; metrics land in <logs>/<name>/")
    p.add_argument("--name", default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: exits if there is no card) "
                        "or 'cpu'")
    return p.parse_args(argv)


def build_data(args, model_cfg, epoch: int = 0, rank: int = 0,
               world: int = 1
               ) -> Tuple[Iterator[Dict[str, np.ndarray]], int]:
    """(epoch ``epoch``'s batches, steps an epoch), as the JAX CLI's
    ``build_data``: CSV and datamix take ``len(dataset) // batch_size``
    steps, webdataset and synthetic ``--train-num-samples //
    batch_size``; ``auto`` picks CSV or webdataset by the first file's
    extension. Of ``world`` ranks, rank ``rank`` gets its contiguous slice
    of each global batch: CSV decodes only its rows; the synthetic draw,
    datamix (whose captions come from one stream over the batch) and
    webdataset make the global batch and keep the slice."""
    from ..parallel.mesh import shard_batch

    batches, steps = _loader(args, model_cfg, epoch, rank, world)
    if world > 1 and _dataset_type(args) != "csv":
        batches = (shard_batch(b, rank, world) for b in batches)
    return batches, steps


def _dataset_type(args) -> str:
    if args.dataset_type != "auto":
        return args.dataset_type
    ext = args.train_data[0].split(".")[-1]
    if ext in ("csv", "tsv"):
        return "csv"
    if ext == "tar":
        return "webdataset"
    raise ValueError(f"cannot infer dataset type from extension {ext!r}")


def _loader(args, model_cfg, epoch: int, rank: int, world: int):
    """(batches, steps an epoch) of the dataset type's loader: the rank's
    rows from CSV, the global batches from the others."""
    from ..text.tokenizer import get_tokenizer

    dataset_type = _dataset_type(args)
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
            rows=slice(rank * args.batch_size // world,
                       (rank + 1) * args.batch_size // world),
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


def build_val_batches(args, model_cfg) -> Iterator[Dict[str, np.ndarray]]:
    """Held-out pair batches, as the JAX CLI's: a CSV/TSV (by extension) in
    file order with a short last batch, else tar shards in order, no
    shuffle."""
    from ..text.tokenizer import get_tokenizer

    tokenizer = get_tokenizer(model_cfg.text.context_length)
    if args.val_data.split(".")[-1] in ("csv", "tsv"):
        from ..data.csv_dataset import CsvPairDataset, csv_batches

        ds = CsvPairDataset(
            args.val_data, img_key=args.csv_img_key,
            caption_key=args.csv_caption_key, sep=args.csv_separator)
        return csv_batches(ds, args.batch_size, model_cfg.vision.image_size,
                           tokenizer, shuffle=False, drop_last=False)
    from ..data.wds import ShardedTarDataset, decode_raw_image_text, \
        wds_batches

    ds = ShardedTarDataset(args.val_data, decode=decode_raw_image_text,
                           shuffle_shards=False)
    return wds_batches(ds, args.batch_size,
                       image_size=model_cfg.vision.image_size,
                       tokenizer=tokenizer, drop_last=False)


# The eval passes. They run the model's own blocks (the training route's)
# with no gradient and deterministic towers (no patch dropout), and return
# L2-normalised fp32 features on the host.


@torch.no_grad()
def encode_image_paths(model, paths: Sequence[str], device: torch.device
                       ) -> np.ndarray:
    """Image files through the eval preprocess ('clip') and the tower."""
    from ..image.preprocess import preprocess_batch

    pixels = preprocess_batch(list(paths), model.cfg.vision.image_size,
                              "clip")
    return model.encode_image(torch.from_numpy(pixels).to(device),
                              normalize=True).float().cpu().numpy()


@torch.no_grad()
def encode_prompts(model, tokenizer, prompts: Sequence[str],
                   device: torch.device) -> np.ndarray:
    ids = torch.from_numpy(tokenizer(list(prompts))).long().to(device)
    return model.encode_text(ids, normalize=True).float().cpu().numpy()


@torch.no_grad()
def validation_features(model, args, device: torch.device
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(image, text) features of the val set's first
    ``--val-num-samples`` pairs, whole batches: the batch that reaches the
    number is the last, as in the JAX CLI."""
    img_f, txt_f = [], []
    n = 0
    for vb in build_val_batches(args, model.cfg):
        vb = _to_device(vb, device)
        out = model(vb["images"], vb["texts"])
        img_f.append(out["image_features"].float().cpu().numpy())
        txt_f.append(out["text_features"].float().cpu().numpy())
        n += vb["images"].shape[0]
        if n >= args.val_num_samples:
            break
    if not img_f:
        return (np.zeros((0, model.cfg.embed_dim), np.float32),) * 2
    return np.concatenate(img_f), np.concatenate(txt_f)


def validation_metrics(img: np.ndarray, txt: np.ndarray,
                       logit_scale: np.ndarray) -> Dict[str, float]:
    """Retrieval recall and ranks both ways, ``clip_val_loss`` (the
    symmetric cross-entropy over the whole set) at ``exp(logit_scale)``,
    and ``num_samples`` (open_clip's ``evaluate``)."""
    from ..evals.metrics import retrieval_metrics

    scale = float(np.exp(logit_scale))
    logits = scale * img @ txt.T
    labels = np.arange(len(img))

    def ce(lg):
        lg = lg - lg.max(axis=1, keepdims=True)
        return float(np.mean(np.log(np.exp(lg).sum(axis=1))
                             - lg[labels, labels]))

    metrics = retrieval_metrics(img, txt, scale)
    metrics["clip_val_loss"] = (ce(logits) + ce(logits.T)) / 2
    metrics["num_samples"] = float(len(img))
    return metrics


def run_validation(model, args, device: torch.device
                   ) -> Optional[Dict[str, float]]:
    img, txt = validation_features(model, args, device)
    if not len(img):
        return None
    return validation_metrics(
        img, txt, model.logit_scale.detach().float().cpu().numpy())


def imagenet_prompts(meta: Dict[str, Sequence[str]]
                     ) -> Tuple[Sequence[str], Sequence[str]]:
    """(classnames, templates) of the shipped metadata: the 1000
    classnames and OpenAI's 80 templates, open_clip's pair. (The JAX CLI
    reads 'classnames' and 'templates', keys the file does not have.)"""
    return meta["IMAGENET_CLASSNAMES"], meta["OPENAI_IMAGENET_TEMPLATES"]


def zero_shot_classifier(model, device: torch.device) -> np.ndarray:
    """[embed_dim, 1000]: the ImageNet classifier of the model's text
    tower, 10 classes (800 prompts) an encode call."""
    from ..evals import zero_shot
    from ..text.tokenizer import get_tokenizer

    tokenizer = get_tokenizer(model.cfg.text.context_length)
    classnames, templates = imagenet_prompts(
        zero_shot.load_imagenet_metadata())
    return zero_shot.build_zero_shot_classifier(
        lambda prompts: encode_prompts(model, tokenizer, prompts, device),
        classnames, templates)


def imagefolder_samples(root: str) -> Tuple[List[str], List[int]]:
    """(paths, class indices) of an ImageFolder root: class directories
    sorted, each indexed in that order into the classnames, files sorted."""
    samples, targets = [], []
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    for ci, cls_dir in enumerate(classes):
        full = os.path.join(root, cls_dir)
        for fn in sorted(os.listdir(full)):
            samples.append(os.path.join(full, fn))
            targets.append(ci)
    return samples, targets


def run_zero_shot(model, args, device: torch.device) -> Dict[str, float]:
    """ImageNet zero-shot top-1 / top-5 on ``--imagenet-val``."""
    from ..evals.zero_shot import zero_shot_eval

    classifier = zero_shot_classifier(model, device)
    samples, targets = imagefolder_samples(args.imagenet_val)
    acc = zero_shot_eval(
        lambda paths: encode_image_paths(model, paths, device), classifier,
        samples, targets, batch_size=args.batch_size)
    return {f"imagenet-zeroshot-val-{k}": v for k, v in acc.items()}


def build_teacher(args, device: torch.device, dtype: torch.dtype,
                  cfg) -> torch.nn.Module:
    """The frozen distillation teacher (``--distill-model``,
    ``--distill-pretrained``: a tag, seeded as the JAX CLI's seed 0, or a
    state-dict path) on composable blocks computing in ``dtype``: its
    parameters in ``dtype``, the logit scale kept fp32, no gradient, eval
    mode. A teacher that cannot take the student's batches exits here."""
    from ..core.config import get_model_config
    from ..core.factory import create_model

    tcfg = get_model_config(args.distill_model, args.distill_pretrained)
    geometry = (tcfg.vision.image_size, tcfg.text.context_length)
    want = (cfg.vision.image_size, cfg.text.context_length)
    if geometry != want:
        raise SystemExit(
            f"--distill-model {args.distill_model} takes images of "
            f"{geometry[0]} px and {geometry[1]} tokens; --model "
            f"{args.model}'s batches have {want[0]} px and {want[1]}")
    teacher = create_model(args.distill_model, args.distill_pretrained,
                           dtype=torch.float32, device=device,
                           compute_dtype=dtype)
    for name, p in teacher.named_parameters():
        if name not in ("logit_scale", "logit_bias"):
            p.data = p.data.to(dtype)
    return teacher.requires_grad_(False)


def _block_impl(args, device: torch.device, dtype: torch.dtype, cfg) -> str:
    """The block route: fused only on the card, where the kernels take the
    shapes the blocks will see (in bf16, the kernels' type): the image
    tower's 1 + kept patches under patch dropout, else 1 + all, and the
    text tower's context. On a zoo model the route is the text tower's
    alone, as JAX's ``block_impl`` reaches only its text tower."""
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
    # a zoo model's vision tower stays composable: only its text tower
    # takes the fused blocks
    if not ((v.tower != "vit"
             or fused_block_supported(rows, v.width, v.heads, v.mlp_ratio))
            and fused_block_supported(t.context_length, t.width, t.heads,
                                      t.mlp_ratio)):
        raise SystemExit(f"--fused-train-blocks: the fused-block kernels do "
                         f"not take the shapes of {args.model}")
    return ("fused-train-res" if args.fused_train_backward == "residual"
            else "fused-train")


# what the JAX CLI does with a ViT-only flag on a zoo vision tower
_VIT_ONLY_FLAGS = {
    "--force-patch-dropout": "drops no patch (its encode_image drops them "
                             "from the ViT alone)",
    "--lock-image-unlocked-groups": "freezes the whole tower, head "
                                    "included (its labels know only the "
                                    "ViT's groups)",
}


def vit_only_flags(args, tower: str) -> List[str]:
    """The flags set in ``args`` that the JAX CLI applies to the ViT alone
    and gets wrong, silently, on the zoo vision ``tower``."""
    if tower == "vit":
        return []
    return [f for f, on in (
        ("--force-patch-dropout", args.force_patch_dropout is not None),
        ("--lock-image-unlocked-groups",
         args.lock_image and args.lock_image_unlocked_groups > 0)) if on]


def dropped_flags(args, coca: bool, distill: bool) -> List[str]:
    """The flags set in ``args`` that the chosen step would drop: the
    distillation step takes neither the SigLIP nor the hard-text loss nor
    grad-cache; CoCa's step none of those, and its factory none of the
    block, remat or patch-dropout options (JAX's ``create_model`` forwards
    none of them to ``create_coca_model``)."""
    flags = []
    if coca:
        flags += [f for f, on in (
            ("--force-patch-dropout", args.force_patch_dropout is not None),
            ("--fused-train-blocks", args.fused_train_blocks),
            ("--grad-checkpointing", args.grad_checkpointing),
            ("--distill-model", distill)) if on]
    if coca or distill:
        flags += [f for f, on in (
            ("--siglip", args.siglip),
            ("--usehardtext", args.usehardtext),
            ("--grad-cache-chunks", args.grad_cache_chunks > 1),
            ("--accum-freq", args.accum_freq > 1)) if on]
    return flags


def _to_device(batch: Dict[str, np.ndarray], device: torch.device):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def _distributed(args) -> bool:
    """Whether this run trains in a process group: under torchrun, in a
    group the caller opened, or with ``--fsdp``."""
    from ..parallel.mesh import distributed

    return args.fsdp or "WORLD_SIZE" in os.environ or distributed()


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ..parallel import mesh as pmesh

    opened = _distributed(args) and not pmesh.distributed()
    try:
        return _train(args)
    finally:
        if opened:
            pmesh.close_distributed()


def _train(args):
    from ..core import checkpoint as ckpt
    from ..core.factory import create_model, resolve_device
    from ..core.config import get_model_config
    from ..parallel import mesh as pmesh
    from ..parallel.sharding_rules import distribute
    from ..train.freeze import apply_freeze, tower_freeze_labels
    from ..train.optim import adamw
    from ..train.schedules import const_lr, const_lr_cooldown, cosine_lr
    from ..train.steps import TrainState, make_clip_train_step
    from ..core.openclip_registry import is_coca, resolve_coca_config

    # distillation is on when both teacher flags are given, as in JAX
    distill = args.distill_model is not None and \
        args.distill_pretrained is not None
    coca = is_coca(args.model)
    # an hf-text name raises JAX's NotImplementedError here, as JAX's does
    cfg = (resolve_coca_config(args.model.replace("/", "-")) if coca
           else get_model_config(args.model, args.pretrained))
    dropped = dropped_flags(args, coca, distill)
    if dropped:
        step = "CoCa's step" if coca else "the distillation step"
        it = "it" if len(dropped) == 1 else "them"
        raise SystemExit(f"{', '.join(dropped)}: {step} would drop {it} "
                         f"(the JAX CLI does, silently); leave {it} out")
    tower = "vit" if coca else cfg.vision.tower
    bad = vit_only_flags(args, tower)
    if bad:
        raise SystemExit("; ".join(
            f"{flag} on the {tower!r} vision tower: the JAX CLI "
            f"{_VIT_ONLY_FLAGS[flag]}, silently" for flag in bad)
            + "; leave it out")
    mesh = None
    if _distributed(args):
        device = pmesh.init_distributed(args.device)
        mesh = pmesh.create_mesh()
    else:
        device = resolve_device(args.device)
    rank, world = pmesh.data_rank(), pmesh.data_world()
    main_rank = rank == 0
    if not main_rank:
        logging.getLogger().setLevel(logging.WARNING)
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} is the global "
                         f"batch: {world} ranks cannot split it evenly")
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    remat = args.grad_checkpointing and (
        args.grad_checkpointing_policy
        if args.grad_checkpointing_policy in ("dots", "attn") else True)
    block_impl = _block_impl(args, device, dtype, cfg)
    if block_impl != "composable":
        # the fused blocks keep only (x, params) per block already
        remat = False
    teacher = build_teacher(args, device, dtype, cfg) if distill else None
    model = create_model(
        args.model, args.pretrained, seed=args.seed, dtype=torch.float32,
        device=device, remat=remat, block_impl=block_impl,
        compute_dtype=dtype, force_quick_gelu=args.force_quick_gelu,
        force_patch_dropout=args.force_patch_dropout, train=True)
    data_iter, steps_per_epoch = build_data(args, model.cfg, rank=rank,
                                            world=world)
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

    start_epoch = 0
    if args.resume and args.checkpoint_dir:
        restored = (ckpt.resume(args.checkpoint_dir)
                    if args.resume == "latest" else ckpt.load(args.resume))
        if restored is not None:
            with torch.no_grad():
                model.load_state_dict(restored["state_dict"])
            start_epoch = int(restored["step"])
            logging.info("resumed at epoch %d", start_epoch)

    # the ranks' wrapper: DDP, or FSDP in place (before the optimizer,
    # which then holds the shards); the logit scale gets no gradient under
    # grad-cache, which DDP must be told
    forward, grad_sync = model, None
    if mesh is not None:
        forward, grad_sync = distribute(
            model, mesh, fsdp=args.fsdp,
            find_unused_parameters=args.grad_cache_chunks > 1)
    state = TrainState(model, adamw(model, args.lr, args.beta1, args.beta2,
                                    args.eps, args.wd),
                       sched, args.grad_clip_norm, grad_sync=grad_sync)

    if distill:
        from ..train.steps import make_distill_train_step

        step_fn = make_distill_train_step(forward, teacher)
    elif coca:
        from ..train.steps import make_coca_train_step

        step_fn = make_coca_train_step(
            forward, caption_loss_weight=args.coca_caption_loss_weight,
            clip_loss_weight=args.coca_contrastive_loss_weight)
    else:
        step_fn = make_clip_train_step(
            forward, use_hard_text=args.usehardtext,
            grad_cache_chunks=args.grad_cache_chunks,
            use_siglip=args.siglip, seed=args.seed)

    # the metrics fan-out (open_clip --report-to; core/logging_utils.py)
    writer = None
    if main_rank and (args.report_to or args.logs):
        from ..core.logging_utils import MetricsLogger

        run_name = args.name or time.strftime("run-%Y%m%d-%H%M%S")
        writer = MetricsLogger(
            log_dir=os.path.join(args.logs, run_name) if args.logs else None,
            report_to=[r for r in args.report_to.split(",") if r],
            run_name=run_name)

    # the checkpoint directory mirrored on a thread (core/remote_sync.py)
    syncer = None
    if main_rank and args.remote_sync and args.checkpoint_dir:
        from ..core.remote_sync import RemoteSync

        syncer = RemoteSync(args.checkpoint_dir, args.remote_sync,
                            every_seconds=args.remote_sync_frequency)
        syncer.start()

    prev_ckpt_step = None
    logging.info("device=%s ranks=%d%s blocks=%s steps/epoch=%d%s", device,
                 world, " (fsdp)" if args.fsdp else "", block_impl,
                 steps_per_epoch,
                 f" distill from {args.distill_model}" if distill else "")
    for epoch in range(start_epoch, args.epochs):
        if epoch > start_epoch or epoch > 0:
            data_iter, _ = build_data(args, model.cfg, epoch=epoch,
                                      rank=rank, world=world)
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
                    seen / dt / world)
                if writer:
                    writer.log({"loss": loss, "lr": sched(state.step),
                                "samples_per_s": seen / dt},
                               step=state.step)
        done = epoch + 1
        # every rank runs the evals (an FSDP forward needs them all); rank
        # 0 reports
        if args.val_data and (done % args.val_frequency == 0
                              or done == args.epochs):
            val = run_validation(model, args, device)
            if val is not None:
                logging.info("val epoch %d: %s", done,
                             {k: round(v, 4) for k, v in val.items()})
                if writer:
                    writer.log_eval(val, done)
        if args.imagenet_val and (done % args.zeroshot_frequency == 0
                                  or done == args.epochs):
            zs = run_zero_shot(model, args, device)
            logging.info("zero-shot epoch %d: %s", done, zs)
            if writer:
                writer.log_eval(zs, done)
        if args.checkpoint_dir and (
                (args.save_frequency > 0 and done % args.save_frequency == 0)
                or done == args.epochs or args.save_most_recent):
            # every rank gathers its shards; rank 0 writes. An async save
            # returns with the state copied to the host, and after the
            # previous async save committed: pruning it is safe
            full = ckpt.full_state_dict(model)
            if main_rank:
                ckpt.save(args.checkpoint_dir,
                          {"state_dict": full, "step": done},
                          step=done, blocking=not args.async_checkpoints)
            del full
            # --delete-previous-checkpoint, or the transient
            # --save-most-recent copy
            if main_rank and prev_ckpt_step is not None and (
                    args.delete_previous_checkpoint
                    or (args.save_most_recent
                        and (args.save_frequency <= 0
                             or prev_ckpt_step % args.save_frequency != 0))):
                old = os.path.join(args.checkpoint_dir,
                                   f"{ckpt.CKPT_PREFIX}{prev_ckpt_step}.pt")
                if os.path.exists(old):
                    os.remove(old)
            prev_ckpt_step = done
        logging.info("epoch %d done in %.2f s", epoch,
                     time.perf_counter() - t0)
    ckpt.wait_for_saves()
    if syncer is not None:
        syncer.stop(final_sync=True)
    logging.info("done: %d steps", state.step)
    return state


if __name__ == "__main__":
    main()
