"""PACL / SPARC head trainer (counterpart of
``clip_embeds_tpu/cli/train_pacl.py``; the reference experiment scripts
Patch-Aligned-Contrastive-Learning/train_pacl.py:78-135 and train_sparc.py).

A frozen CLIP tower feeds trainable patch/text projection heads
(``models/heads.py``); PACL optimizes in-batch InfoNCE at fixed T = 0.1,
SPARC the global + local grouped-patch objective. Adam, lr 1e-4, no
schedule, as the reference.

  python -m clip_embeds_tpu_torch.cli.train_pacl --objective pacl \\
      --model ViT-L-14-336 --pretrained /ckpt.pt \\
      --data blip_laion_cc_sbu_558k.json --image-roots /data/llava \\
      [--embed-paths single_embed.npy]   # LLM2CLIP-PACL variant \\
      --epochs 10 --batch-size 4096 --output pacl_head.npz [--device cpu]

``--synthetic`` trains on random pairs (smoke runs). The frozen tower runs
under ``torch.no_grad()`` with its parameters frozen, so only the head's
activations are kept for the backward. ``--frozen-tower``:

* ``composable``: the model's own towers in ``--precision``;
* ``fused``: images through ``fused_encode_image`` (the bf16 fused-block
  kernels, all blocks, tokens out), PACL texts through ``fused_encode_text``;
* ``int8``: images through ``fused_encode_image_int8`` (W8A8, calibrated on
  the first batch), texts as ``fused``;
* ``auto`` (default): ``fused`` on the card, ``composable`` elsewhere.

SPARC's text tokens always come from the composable text tower. The kernel
routes run only on the card (an error with ``--device cpu``), and before
training they are held to the composable tower on the first batch: the
cosine over all patch tokens must reach 0.999, or the command exits with an
error that names it. The head is saved as the JAX package's ``.npz``
(``--output``), which either package's eval reads. ``main(argv)`` returns
the final :class:`HeadTrainState`, whose ``report`` holds the gate's
cosine, the logged losses and samples/s and the peak device memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np
import torch

from ..train.steps import TrainState

GATE_MIN_COS = 0.999  # the kernel routes' first-batch patch-token cosine


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--objective", default="pacl", choices=["pacl", "sparc"])
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--proj-dim", type=int, default=768)
    p.add_argument("--rope", default="none",
                   choices=["none", "before", "after"],
                   help="PACL RoPE ablation / SPARC rope (any non-'none')")
    p.add_argument("--pooling", default="weighted",
                   choices=["weighted", "uniform"],
                   help="PACL train-time patch pooling (eval uses the "
                        "committed uniform quirk)")
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--data", nargs="*", default=None,
                   help="LLaVA-format annotation json files")
    p.add_argument("--image-roots", nargs="*", default=None)
    p.add_argument("--embed-paths", nargs="*", default=None,
                   help="precomputed LLM text-embedding .npy per annotation "
                        "file (LLM2CLIP-PACL)")
    p.add_argument("--synthetic", action="store_true",
                   help="random pairs instead of real data (smoke runs)")
    p.add_argument("--train-num-samples", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--sparc-sigma", type=float, default=None,
                   help="patch-grouping threshold (default 1/num_patches)")
    p.add_argument("--sparc-global-weight", type=float, default=0.5)
    p.add_argument("--sparc-local-weight", type=float, default=1.0)
    p.add_argument("--frozen-tower", default="auto",
                   choices=["auto", "composable", "fused", "int8"],
                   help="how the frozen CLIP tower runs: composable, the "
                        "bf16 fused-block kernels, or W8A8 int8 fused "
                        "(calibrated on the first batch); 'auto' is fused "
                        "on the card, composable elsewhere. The kernel "
                        f"routes must reach a first-batch cosine of "
                        f"{GATE_MIN_COS} against composable")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--output", default=None, help="head params .npz path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: exits if there is no card) "
                        "or 'cpu'")
    return p.parse_args(argv)


def _synthetic_batches(args, image_size, context_length, embed_dim=None):
    """Random pairs, the JAX CLI's ``_synthetic_batches`` draw for draw."""
    rng = np.random.default_rng(args.seed)
    steps = max(args.train_num_samples // args.batch_size, 1)
    for _ in range(steps):
        batch = {
            "images": rng.standard_normal(
                (args.batch_size, image_size, image_size, 3)
            ).astype(np.float32),
            "texts": np.concatenate([
                np.full((args.batch_size, 1), 49406),
                rng.integers(1000, 40000,
                             (args.batch_size, context_length - 2)),
                np.full((args.batch_size, 1), 49407),
            ], axis=1).astype(np.int32),
        }
        if embed_dim:
            batch["text_embeddings"] = rng.standard_normal(
                (args.batch_size, embed_dim)).astype(np.float32)
        yield batch


def frozen_tower_route(requested: str, device: torch.device, model) -> str:
    """The route ``--frozen-tower`` gives on ``device``: 'auto' is 'fused'
    on the card where the kernels take the model's shapes; the kernel
    routes are refused elsewhere (no silent fallback)."""
    from ..models.serving import fused_path_available

    on_card = device.type == "cuda"
    if requested == "auto":
        return ("fused" if on_card and fused_path_available(model)
                else "composable")
    if requested != "composable":
        if not on_card:
            raise SystemExit(
                f"--frozen-tower {requested} runs the fused-block kernels, "
                f"which need the card; --device {device} cannot take it "
                "(use --frozen-tower composable)")
        if not fused_path_available(model):
            raise SystemExit(f"--frozen-tower {requested}: the fused-block "
                             "kernels do not take this model's shapes")
    return requested


def make_frozen_features(model, objective: str, dtype: torch.dtype,
                         route: str, qtower=None):
    """feats(batch) -> (patch tokens [B, P, width], text features) in
    ``dtype``, under no_grad: the composable towers, or the image tower
    (and PACL's pooled text) through the fused-block kernels. PACL takes
    the text CLS embedding [B, embed_dim] or the batch's
    'text_embeddings'; SPARC the composable text tokens [B, ctx, width]."""
    from ..models.serving import (
        fused_encode_image,
        fused_encode_image_int8,
        fused_encode_text,
    )

    bf16 = torch.bfloat16

    def patch_tokens(images):
        if route == "composable":
            return model.encode_image(images.to(dtype),
                                      output_tokens=True)[1]
        if qtower is not None:
            _, tokens = fused_encode_image_int8(
                model, qtower, images.to(bf16), normalize=False,
                output_tokens=True)
        else:
            _, tokens = fused_encode_image(model, images.to(bf16),
                                           normalize=False,
                                           output_tokens=True)
        return tokens.to(dtype)

    @torch.no_grad()
    def feats(batch):
        patches = patch_tokens(batch["images"])
        if objective == "sparc":
            return patches, model.encode_text(batch["texts"],
                                              output_tokens=True)[1]
        if "text_embeddings" in batch:
            return patches, batch["text_embeddings"].to(dtype)
        if route == "composable":
            return patches, model.encode_text(batch["texts"])
        return patches, fused_encode_text(model, batch["texts"],
                                          normalize=False).to(dtype)

    return feats


def build_head(args, cfg, text_dim: int, dtype: torch.dtype):
    """The head ``args`` ask for (``--objective``, ``--proj-dim``,
    ``--rope``, ``--pooling``, ``--dropout``) over the tower's patch width
    and ``text_dim``, computing in ``dtype``, with flax's initialisation
    from ``--seed``; on the CPU."""
    from ..models.heads import PACLHead, SPARCHead, init_head

    if args.objective == "pacl":
        head = PACLHead(cfg.vision.width, text_dim, args.proj_dim,
                        rope=args.rope, pooling=args.pooling,
                        dropout=args.dropout, compute_dtype=dtype)
    else:
        head = SPARCHead(cfg.vision.width, text_dim, args.proj_dim,
                         rope=args.rope != "none", dropout=args.dropout,
                         compute_dtype=dtype)
    return init_head(head, args.seed)


def make_head_loss(args, cfg, generator: torch.Generator):
    """loss_of_head(head, feats, batch) -> (loss, {}) for
    ``make_frozen_tower_train_step``: PACL's InfoNCE at ``--temperature``,
    or SPARC's global + local loss (sigma ``--sparc-sigma``, default
    1 / the tower's patch count); dropout masks from ``generator``."""
    from ..losses.clip_loss import pacl_clip_loss
    from ..losses.sparc import sparc_group_patches, sparc_loss
    from ..models.clip import l2_normalize
    from ..models.heads import language_mask_from_ids

    sigma = (args.sparc_sigma if args.sparc_sigma is not None
             else 1.0 / cfg.vision.num_patches)

    def loss_of_head(head, feats, batch):
        patches, text_feat = feats
        out = head(patches, text_feat, generator=generator)
        if args.objective == "pacl":
            return pacl_clip_loss(*out, args.temperature), {}
        vproj, tproj = out
        tnorm = l2_normalize(tproj)
        # reference pacl.py:475 normalizes the grouped embeddings before
        # the local InfoNCE
        grouped = l2_normalize(sparc_group_patches(vproj, tnorm, sigma))
        loss = sparc_loss(
            vproj, tnorm, grouped, language_mask_from_ids(batch["texts"]),
            temperature=args.temperature,
            global_weight=args.sparc_global_weight,
            local_weight=args.sparc_local_weight,
        )
        return loss, {}

    return loss_of_head


@torch.no_grad()
def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-12))


def _dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.precision == "bf16" else torch.float32


@dataclasses.dataclass
class HeadTrainState(TrainState):
    """The head's :class:`~..train.steps.TrainState`, with what ``main``
    measured in ``report``: 'route', 'gate_cos' (None on the composable
    route), 'losses' and 'samples_per_s' at each logged step, and
    'peak_gib' (the card's peak allocated memory; None elsewhere)."""

    report: dict = dataclasses.field(default_factory=dict)


def build_trainer(args, model, route: str, first):
    """The frozen-tower trainer that ``args`` ask for on ``route``, on the
    device of the ``first`` batch: ``(tower_fn, state, step)``. The int8
    route's tower is calibrated on ``first``'s images; the head's text
    width is that of ``first``'s 'text_embeddings' where it has them."""
    from ..models.serving import prepare_int8_tower
    from ..train.optim import adam
    from ..train.schedules import const_lr
    from ..train.steps import make_frozen_tower_train_step

    cfg, dtype = model.cfg, _dtype(args)
    device = first["images"].device
    qtower = None
    if route == "int8":
        logging.info("calibrating W8A8 tower on the first batch "
                     "(%d images)", first["images"].shape[0])
        with torch.no_grad():
            qtower = prepare_int8_tower(
                model, first["images"].to(torch.bfloat16), torch.bfloat16)
    tower_fn = make_frozen_features(model, args.objective, dtype, route,
                                    qtower)
    if "text_embeddings" in first:
        text_dim = first["text_embeddings"].shape[-1]
    else:
        text_dim = cfg.text.width if args.objective == "sparc" \
            else cfg.embed_dim
    head = build_head(args, cfg, text_dim, dtype).to(device).train()
    # dropout masks: one generator on the device, seeded once; JAX folds
    # (seed, step) into a key, whose masks no torch generator reproduces
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = HeadTrainState(head, adam(head, args.lr), const_lr(args.lr))
    step = make_frozen_tower_train_step(make_head_loss(args, cfg, gen))
    return tower_fn, state, step


def gate_cosine(model, tower_fn, first, route: str, dtype) -> float:
    """The kernel route's cosine over all of ``first``'s patch tokens
    against the composable tower in ``dtype``; exits below GATE_MIN_COS."""
    with torch.no_grad():
        ref_p = model.encode_image(first["images"].to(dtype),
                                   output_tokens=True)[1]
    got_p, _ = tower_fn(first)
    if got_p.shape != ref_p.shape:
        raise SystemExit(f"--frozen-tower {route}: tokens "
                         f"{tuple(got_p.shape)} != the composable "
                         f"tower's {tuple(ref_p.shape)}")
    cos = _cosine(ref_p, got_p)
    logging.info("frozen-tower %s patch-token cosine vs composable: "
                 "%.6f", route, cos)
    if not cos >= GATE_MIN_COS:
        raise SystemExit(
            f"--frozen-tower {route}: first-batch cosine {cos:.6f} "
            f"< {GATE_MIN_COS} vs the composable tower; refusing to "
            "train on out-of-tolerance features (rerun with "
            "--frozen-tower composable)")
    return cos


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ..core.convert import jax_params_from_head
    from ..core.factory import create_model, resolve_device, save_params_npz
    from .train import _to_device

    device = resolve_device(args.device)
    dtype = _dtype(args)
    model = create_model(args.model, args.pretrained, seed=args.seed,
                         dtype=torch.float32, device=device,
                         compute_dtype=dtype)
    model.requires_grad_(False)
    cfg = model.cfg
    route = frozen_tower_route(args.frozen_tower, device, model)

    use_llm_embeds = bool(args.embed_paths)
    if args.synthetic or not args.data:
        if not args.synthetic:
            raise SystemExit("--data (+ --image-roots) or --synthetic needed")
        embed_dim = 4096 if use_llm_embeds else None
        batches = lambda epoch=0: _synthetic_batches(  # noqa: E731
            args, cfg.vision.image_size, cfg.text.context_length, embed_dim)
    else:
        from ..data.pacl_data import PACLCaptionDataset, pacl_batches
        from ..text.tokenizer import get_tokenizer

        ds = PACLCaptionDataset(
            args.data, args.image_roots or ["."] * len(args.data),
            image_size=cfg.vision.image_size,
            embed_paths=args.embed_paths, seed=args.seed,
        )
        tok = get_tokenizer(cfg.text.context_length)
        batches = lambda epoch=0: pacl_batches(  # noqa: E731
            ds, args.batch_size, tokenizer=tok, seed=args.seed, epoch=epoch)
    first = _to_device(next(iter(batches())), device)
    tower_fn, state, step = build_trainer(args, model, route, first)
    report = state.report
    report.update(route=route, gate_cos=None, losses=[], samples_per_s=[],
                  peak_gib=None)
    if route != "composable":
        report["gate_cos"] = gate_cosine(model, tower_fn, first, route,
                                         dtype)
    logging.info("frozen tower route: %s", route)

    n_params = sum(p.numel() for p in state.model.parameters())
    logging.info("objective=%s trainable head params=%d (frozen tower: %s, "
                 "%s)", args.objective, n_params, args.model, route)
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        seen = 0
        for i, batch in enumerate(batches(epoch)):
            batch = _to_device(batch, device)
            metrics = step(state, tower_fn(batch), batch)
            seen += args.batch_size
            if (i + 1) % args.log_every == 0 or i == 0:
                loss = float(metrics["loss"])  # waits
                rate = seen / (time.perf_counter() - t0)
                report["losses"].append(loss)
                report["samples_per_s"].append(rate)
                logging.info("epoch %d step %d loss %.4f samples/s %.1f",
                             epoch, i + 1, loss, rate)
    if device.type == "cuda":
        report["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        logging.info("peak device memory %.2f GiB", report["peak_gib"])
    if args.output:
        save_params_npz(jax_params_from_head(state.model), args.output)
        logging.info("saved head -> %s", args.output)
    return state

if __name__ == "__main__":
    main()
