"""Evaluation CLI (counterpart of ``clip_embeds_tpu/cli/eval.py``): the
reference's per-family evaluation scripts behind one dispatcher, with
``--scorer clip|siglip|pacl|sparc`` on What'sUp A/B (2 and 4 options),
COCO/VG-spatial one/two objects, MMVP and MMVP-VLM.

  python -m clip_embeds_tpu_torch.cli.eval --scorer clip \
      --model ViT-L-14-336 --pretrained /path/ckpt.pt --dataset a \
      --root-dir /data/whatsup [--precision bf16|fp32] [--device cuda|cpu]
  python -m clip_embeds_tpu_torch.cli.eval --scorer pacl|sparc \
      --model-path head.npz [--rope none|before|after] [--sparc-local] ...

It takes the JAX CLI's arguments, and ``--device`` (default ``cuda``: an
error without a card unless given ``--device cpu``). ``--model-path`` is a
PACL/SPARC head ``.npz`` of either package (``cli/train_pacl.py
--output``); without it the head is a fresh init from seed 0. The PACL head
scores with uniform pooling, the reference's eval override. ``--scorer
siglip`` resolves a SigLIP registry name (``core/openclip_registry.py``)
and then exits, as the JAX CLI does: its ``SigLipTokenizer`` needs the
path of a sentencepiece ``.model``, which the CLI has no flag to give (so
``scores.scorers.SiglipScorer`` is driven with an injected tokenizer).
``--scorer embedding`` raises the JAX CLI's NotImplementedError: the
LLaVA embedding scorer is built directly
(``scores.embedding_scorer.EmbeddingScorer``, ``cli/eval_mmeb.py``).
Images decode on the native C++ pipeline where its library builds, else
with PIL. The results table is printed as the JAX CLI prints it, then one
JSON line naming the scorer's route, the decoder that ran, the device and
the samples/s.
"""

from __future__ import annotations

import argparse
import json
import logging
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser("clip_embeds_tpu_torch eval")
    p.add_argument("--scorer", default="clip",
                   choices=["clip", "siglip", "pacl", "sparc", "embedding"])
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--model-path", default=None,
                   help="PACL/SPARC head checkpoint (.npz)")
    p.add_argument("--dataset", default="a",
                   choices=["a", "b", "a4", "b4", "cocoone", "cocotwo",
                            "vgone", "vgtwo", "mmvp", "mmvpvlm"])
    p.add_argument("--root-dir", required=True)
    p.add_argument("--results-file", default="evaluation_results.txt")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--rope", default="none",
                   choices=["none", "before", "after"])
    p.add_argument("--sparc-local", action="store_true")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: exits if there is no card) "
                   "or 'cpu'")
    return p.parse_args(argv)


def build_head(args, model):
    """The PACL (uniform pooling) or SPARC head of ``--scorer``, fp32 on the
    model's device: ``--model-path``'s weights, else a fresh init from seed
    0."""
    from ..core.convert import head_state_dict_from_jax_params
    from ..core.factory import load_params_npz
    from ..models.heads import PACLHead, SPARCHead, init_head

    cfg = model.cfg
    if args.scorer == "pacl":
        head = PACLHead(cfg.vision.width, cfg.embed_dim, cfg.embed_dim,
                        rope=args.rope)
    else:
        head = SPARCHead(cfg.vision.width, cfg.text.width, cfg.embed_dim,
                         rope=args.rope != "none")
    if args.model_path:
        head.load_state_dict(head_state_dict_from_jax_params(
            load_params_npz(args.model_path)))
    else:
        init_head(head, seed=0)
    return head.to(model.text_projection.device)


def build_siglip_scorer(args, dtype):
    """The JAX CLI's SigLIP branch: a SigLIP registry config, its tokenizer
    (which exits: ``SigLipTokenizer`` needs a ``.model`` path the CLI does
    not take), then the model, from an HF ``SiglipModel`` state dict
    (``--pretrained``) or seeded random weights."""
    import torch

    from ..core.convert import siglip_state_dict_from_hf
    from ..core.factory import resolve_device
    from ..core.openclip_registry import resolve_siglip_config
    from ..models.siglip import Siglip, cast_siglip, create_siglip
    from ..scores.scorers import SiglipScorer
    from ..text import tokenizer

    cfg = resolve_siglip_config(args.model)
    try:
        tokenize = tokenizer.SigLipTokenizer()
    except Exception:
        raise SystemExit(
            "SigLIP tokenizer needs sentencepiece; pass texts through "
            "scores.scorers.SiglipScorer with an injected tokenizer"
        )
    device = resolve_device(args.device)
    if args.pretrained:
        model = Siglip(cfg)
        model.load_state_dict(siglip_state_dict_from_hf(torch.load(
            args.pretrained, map_location="cpu", weights_only=True)))
        model = cast_siglip(model.to(device), dtype).eval()
    else:
        model = create_siglip(cfg, seed=0, dtype=dtype, device=device)
    return SiglipScorer(model, tokenize, batch_size=args.batch_size)


def build_scorer(args):
    import torch

    from ..core.factory import create_model, resolve_device
    from ..scores.scorers import CLIPScorer, PACLScorer, SPARCScorer

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.scorer == "siglip":
        return build_siglip_scorer(args, dtype)
    device = resolve_device(args.device)
    model = create_model(args.model, args.pretrained, dtype=dtype,
                         device=device)
    if args.scorer == "clip":
        return CLIPScorer(model, batch_size=args.batch_size)
    if args.scorer == "embedding":
        raise NotImplementedError(
            "embedding scorer needs a LLaVA checkpoint + HF tokenizer; "
            "construct scores.embedding_scorer.EmbeddingScorer directly")
    head = build_head(args, model)
    if args.scorer == "pacl":
        return PACLScorer(model, head, batch_size=args.batch_size)
    return SPARCScorer(model, head, batch_size=args.batch_size,
                       local=args.sparc_local)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..core.factory import device_name
    from ..evals.mmvp import eval_mmvp
    from ..evals.whatsup import eval_coco_vg, eval_whatsup, load_annotation
    from ..native.build import decoder_name

    scorer = build_scorer(args)
    with open(args.results_file, "a") as f:
        f.write("Model path: {} ".format(args.model_path or args.model))
        f.write("Dataset: {}\n".format(args.dataset))

    t0 = time.perf_counter()
    if args.dataset in ("mmvp", "mmvpvlm"):
        pairs = []

        def pair_score(images, texts):
            pairs.append(images)
            return scorer.pair_score(images, texts)

        results = eval_mmvp(
            pair_score, args.root_dir, args.dataset,
            results_file=args.results_file,
        )
        samples = len(pairs)
    else:
        dataset, _ = load_annotation(args.root_dir, args.dataset)
        if args.dataset in ("a", "b", "a4", "b4"):
            results = eval_whatsup(
                scorer.score_batch, dataset, args.root_dir,
                four_option=args.dataset.endswith("4"),
                results_file=args.results_file,
            )
        else:
            results = eval_coco_vg(
                scorer.score_batch, dataset, args.root_dir,
                "coco" if args.dataset.startswith("coco") else "vg",
                results_file=args.results_file,
            )
        samples = len(dataset)
    seconds = time.perf_counter() - t0
    print(json.dumps(results, indent=2))
    print(json.dumps({
        "scorer": args.scorer, "route": scorer.route,
        "decoder": decoder_name(), "device": device_name(scorer.device),
        "samples": samples, "seconds": round(seconds, 3),
        "samples_per_s": round(samples / seconds, 2),
    }))
    return results


if __name__ == "__main__":
    main()
