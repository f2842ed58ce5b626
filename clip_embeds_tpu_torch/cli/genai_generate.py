"""GenAI-Bench image generation CLI, the generate half of the
generate -> score workflow (a copy of
``clip_embeds_tpu/cli/genai_generate.py``;
t2v_metrics/genai_bench/generate.py): iterate the GenAI-Bench prompts,
produce one image per prompt, and save it as
``<output_dir>/<gen_model>/<prompt_idx>.jpeg``, the layout the scoring
half (the port's ``evals/benchmarks.py GenAIBench``) reads back.

The reference hardcodes a diffusers StableDiffusionPipeline; the image
source here is injectable: any callable
``source(prompt: str, prompt_idx: str, seed: int) -> PIL.Image``. The
CLI itself runs on the host; only the diffusers source places a model,
on ``--device`` (the card by default; without one it exits unless given
``--device cpu``).

  --image-source diffusers         reference behavior (needs diffusers and
                                   a local checkpoint; an actionable error
                                   where the package is absent)
  --image-source synthetic         deterministic procedural images — proves
                                   the generate->score pipeline end to end
                                   without any model
  --image-source pkg.module:fn     any user callable (a diffusion model,
                                   an API client, ...)

Usage:
  python -m clip_embeds_tpu_torch.cli.genai_generate \
      --prompts /data/genai_image/genai_image.json \
      --gen-model my-model --output-dir ./outputs \
      --image-source pkg.module:fn
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
from typing import Callable, Dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prompts", required=True,
                   help="GenAI-Bench prompt json: either the reference "
                        "{prompt_idx: {'prompt': ...}} mapping "
                        "(genai_image.json) or a plain list of strings")
    p.add_argument("--num-prompts", type=int, default=None,
                   help="cap at the first N prompts (reference: 527 for the "
                        "VQAScore paper subset, 1600 full)")
    p.add_argument("--gen-model", default="synthetic",
                   help="subdirectory name for the outputs (the reference "
                        "uses the HF diffusion model id)")
    p.add_argument("--output-dir", default="./outputs")
    p.add_argument("--image-source", default="synthetic",
                   help="'diffusers', 'synthetic', or 'module:callable'")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=9.0)
    p.add_argument("--negative-prompt", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="the diffusers source's device: 'cuda' (the "
                        "default: exits if there is no card) or 'cpu'")
    return p.parse_args(argv)


def load_prompts(path: str) -> Dict[str, str]:
    """{prompt_idx: prompt}; accepts the reference mapping or a plain list."""
    with open(path) as fh:
        data = json.load(fh)
    if isinstance(data, list):
        return {str(i): (p["prompt"] if isinstance(p, dict) else p)
                for i, p in enumerate(data)}
    return {k: (v["prompt"] if isinstance(v, dict) else v)
            for k, v in data.items()}


def synthetic_source(size: int = 256) -> Callable:
    """Deterministic prompt-seeded procedural images (pipeline smoke runs)."""
    import hashlib

    import numpy as np
    from PIL import Image

    def generate(prompt: str, prompt_idx: str, seed: int):
        digest = hashlib.sha256(
            f"{seed}:{prompt_idx}:{prompt}".encode()).digest()
        rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
        # low-frequency noise so JPEG round-trips stay stable
        base = rng.random((8, 8, 3))
        arr = np.kron(base, np.ones((size // 8, size // 8, 1)))
        return Image.fromarray((arr * 255).astype(np.uint8))

    return generate


def diffusers_source(args) -> Callable:
    """Reference behavior: StableDiffusionPipeline (generate.py:104-131)."""
    try:
        import torch
        from diffusers import StableDiffusionPipeline
    except ImportError as e:
        raise SystemExit(
            "--image-source diffusers needs the diffusers package and a "
            "downloaded checkpoint (neither ships with this package). "
            "Install diffusers or inject a callable via --image-source "
            "pkg.module:fn") from e
    from ..core.factory import resolve_device

    device = resolve_device(args.device)
    pipe = StableDiffusionPipeline.from_pretrained(
        args.gen_model, torch_dtype=torch.float16)
    pipe = pipe.to(device)
    torch.manual_seed(args.seed)

    def generate(prompt: str, prompt_idx: str, seed: int):
        return pipe(
            prompt, height=args.height, width=args.width,
            num_inference_steps=args.steps, guidance_scale=args.scale,
            num_images_per_prompt=1,
            negative_prompt=args.negative_prompt or None,
        ).images[0]

    return generate


def resolve_source(args) -> Callable:
    if args.image_source == "synthetic":
        return synthetic_source()
    if args.image_source == "diffusers":
        return diffusers_source(args)
    mod_name, _, fn_name = args.image_source.partition(":")
    if not fn_name:
        raise SystemExit(
            f"--image-source {args.image_source!r}: expected 'diffusers', "
            "'synthetic', or 'module:callable'")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn() if isinstance(fn, type) else fn


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    prompts = load_prompts(args.prompts)
    keys = sorted(prompts, key=lambda k: (len(k), k))
    if args.num_prompts:
        keys = keys[: args.num_prompts]
    out_dir = os.path.join(args.output_dir, args.gen_model)
    os.makedirs(out_dir, exist_ok=True)

    source = resolve_source(args)
    for i, k in enumerate(keys):
        img = source(prompts[k], k, args.seed)
        img.save(os.path.join(out_dir, f"{k}.jpeg"))
        if (i + 1) % 100 == 0 or i + 1 == len(keys):
            logging.info("generated %d/%d", i + 1, len(keys))
    print(f"Done, saved to {out_dir}")
    print("Score with: python -m clip_embeds_tpu_torch.cli.t2v_eval "
          f"--datasets genai_bench --root_dir <root> (images from {out_dir})")
    return out_dir


if __name__ == "__main__":
    main()
