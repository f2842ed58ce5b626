"""t2v_metrics-style benchmark loop: one score model x many datasets (the
port of ``clip_embeds_tpu/cli/t2v_eval.py``).

The score model resolves as in the JAX CLI:

  * a CLIP config name (e.g. ViT-L-14-336) -> CLIPScore
  * 'siglip:<arch>' -> SigLIP sigmoid pairing (--siglip-tokenizer points at
    a local sentencepiece .model)
  * a registered VQAScore or ITMScore name (llava-v1.5-7b,
    clip-flant5-xxl, instructblip-flant5-xxl, blip2-itm, blip2-itc,
    image-reward-v1, ...) with --checkpoint <score bundle> ->
    scores.registry.get_score_model (the bundle must hold its tokenizer/
    directory, and InstructBLIP's its qformer_tokenizer/: this CLI passes
    no tokenizer)

``--device`` (default ``cuda``) exits with an error without a card unless
given ``--device cpu``.

Usage:
  python -m clip_embeds_tpu_torch.cli.t2v_eval --model ViT-L-14-336 \\
      --pretrained /ckpt.pt --root_dir /data/t2v --datasets winoground
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

DEFAULT_DATASETS = [
    # the reference eval.py main loop
    "winoground", "naturalbench_retrieval", "eqben_mini", "seetrue",
    "sugarcrepe", "cococounterfactuals",
]


def build_score(args):
    import torch

    from ..core.factory import create_model, resolve_device
    from ..scores.registry import list_all_models
    from ..scores.score import CLIPScore, Score

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    device = resolve_device(args.device)
    if args.model.startswith("siglip:"):
        from ..core.convert import siglip_state_dict_from_hf
        from ..core.openclip_registry import resolve_siglip_config
        from ..models.siglip import Siglip, cast_siglip, create_siglip
        from ..scores.scorers import SiglipScorer
        from ..text.tokenizer import SigLipTokenizer

        if not args.siglip_tokenizer:
            raise SystemExit(
                "siglip scoring needs --siglip-tokenizer "
                "<local sentencepiece .model file>"
            )
        cfg = resolve_siglip_config(args.model.split(":", 1)[1])
        if args.pretrained:
            smodel = Siglip(cfg)
            smodel.load_state_dict(siglip_state_dict_from_hf(torch.load(
                args.pretrained, map_location="cpu", weights_only=True)))
            smodel = cast_siglip(smodel.to(device), dtype).eval()
        else:
            smodel = create_siglip(cfg, seed=0, dtype=dtype, device=device)
        scorer = SiglipScorer(smodel, SigLipTokenizer(args.siglip_tokenizer),
                              batch_size=args.batch_size)
        return Score(lambda images, texts: scorer.sigmoid_scores(
            images, texts).diagonal())
    if args.checkpoint or (":" not in args.model
                           and args.model in list_all_models()):
        from ..scores.registry import get_score_model

        return get_score_model(args.model, checkpoint=args.checkpoint,
                               device=str(device),
                               batch_size=args.batch_size)
    model = create_model(args.model, args.pretrained, dtype=dtype,
                         device=device)
    return CLIPScore(model, batch_size=args.batch_size)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root_dir", default="./datasets")
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="score bundle dir for VQAScore names")
    p.add_argument("--siglip-tokenizer", default=None,
                   help="local sentencepiece .model for siglip:<arch>")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--datasets", nargs="+", default=DEFAULT_DATASETS)
    p.add_argument("--output", default=None,
                   help="optional results .json path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error without a card) or cpu")
    args = p.parse_args(argv)

    from ..evals.benchmarks import get_benchmark, run_benchmark

    score = build_score(args)
    results = {}
    for name in args.datasets:
        try:
            dataset = get_benchmark(name, args.root_dir)
        except FileNotFoundError as e:
            print(f"{name}: data missing ({e}); skipping", file=sys.stderr)
            continue
        _, metrics = run_benchmark(score, dataset,
                                   batch_size=args.batch_size)
        results[name] = metrics
        print(name, json.dumps(metrics))
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
