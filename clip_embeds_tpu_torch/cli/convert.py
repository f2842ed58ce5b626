"""Convert reference checkpoints into score bundles, one command
(counterpart of ``clip_embeds_tpu/cli/convert.py``; same flags and
bundle).

    python -m clip_embeds_tpu_torch.cli.convert --name llava-v1.5-7b \\
        --checkpoint /path/hf_dir_or_file.pt --out /bundles/llava-7b \\
        [--tokenizer /path/hf_tokenizer_dir] [--config tiny_config.json]

Then ``get_score_model('llava-v1.5-7b', checkpoint='/bundles/llava-7b')``
(``scores/registry.py``) builds the scorer on the card, in either package:
the bundle is the JAX layout (``config.json`` + ``params.npz`` holding the
flax tree). The checkpoint is a torch file (.pt/.pth/.bin) or an HF
directory (sharded ``pytorch_model*.bin`` or ``*.safetensors``);
``--config`` overrides the family's full-size config with a JSON dict
(scaled-down checkpoints). The conversion runs on the host: nothing here
touches a device.

Family -> converter (``core/convert.py``, ``models/phi3.py``):
  llava-v1.5/v1.6/sharegpt4v  HF LlavaForConditionalGeneration layout
  llava-phi-3                 same layout, Phi-3 packed-projection LM
  llava-llama-3               same layout, Llama-3 (GQA) LM
  clip-flant5-*               CLIPT5ForConditionalGeneration layout
  instructblip-flant5-*       HF InstructBlipForConditionalGeneration
  blip2-itm*/blip2-itc*       HF Blip2ForImageTextRetrieval
  image-reward-v1             THUDM ImageReward checkpoint
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Any, Dict


def load_state_dict(path: str) -> Dict[str, Any]:
    """A torch file or an HF directory (bin shards, or safetensors, which
    win where both are there) -> one state dict."""
    import torch

    if os.path.isfile(path):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return sd
    entries = sorted(os.listdir(path))
    safes = [e for e in entries if e.endswith(".safetensors")]
    bins = [e for e in entries
            if e.endswith(".bin") and e.startswith("pytorch_model")]
    sd: Dict[str, Any] = {}
    if safes:
        from safetensors.torch import load_file

        for e in safes:
            sd.update(load_file(os.path.join(path, e)))
    elif bins:
        for e in bins:
            sd.update(torch.load(os.path.join(path, e), map_location="cpu",
                                 weights_only=False))
    else:
        raise FileNotFoundError(
            f"no pytorch_model*.bin or *.safetensors under {path!r}")
    return sd


def convert_for_name(name: str, sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The flax tree of a registered score name's checkpoint, through the
    family's converter (JAX's dispatch)."""
    from ..core import convert as cv
    from ..scores.registry import (
        BLIP2_ITC_MODELS,
        BLIP2_ITM_MODELS,
        CLIP_T5_MODELS,
        IMAGE_REWARD_MODELS,
        INSTRUCTBLIP_MODELS,
        LLAVA16_MODELS,
        LLAVA_LLAMA_MODELS,
        LLAVA_MODELS,
    )

    if name in LLAVA_MODELS + LLAVA16_MODELS:
        return cv.convert_llava_state_dict(sd)
    if name in LLAVA_LLAMA_MODELS:
        # the vision tower and projector of the LLaVA layout, the LM by
        # backbone
        sd = cv._normalize_llava_keys(sd)
        params = {
            "vision_tower": cv.convert_hf_clip_vision_state_dict(
                sd, prefix="vision_tower.vision_model."),
            "multi_modal_projector": {
                f"linear_{i}": cv._flax_linear(
                    sd, f"multi_modal_projector.linear_{i}")
                for i in (1, 2)},
        }
        if name == "llava-phi-3":
            from ..models.phi3 import convert_phi3_state_dict

            params["language_model"] = convert_phi3_state_dict(
                sd, cfg.llama, prefix="language_model.")
        else:  # llava-llama-3: the GQA Llama layout
            params["language_model"] = cv.convert_llama_state_dict(
                sd, prefix="language_model.")
        return params
    if name in CLIP_T5_MODELS:
        return cv.convert_clip_t5_state_dict(sd)
    if name in INSTRUCTBLIP_MODELS:
        return cv.convert_instructblip_state_dict(sd)
    if name in BLIP2_ITM_MODELS + BLIP2_ITC_MODELS:
        return cv.convert_blip2_state_dict(sd)
    if name in IMAGE_REWARD_MODELS:
        return cv.convert_image_reward_state_dict(sd)
    raise KeyError(f"no converter route for {name!r}")


def main(argv=None):
    p = argparse.ArgumentParser("clip_embeds_tpu_torch score-bundle "
                                "converter")
    p.add_argument("--name", required=True,
                   help="registered score-model name (scores/registry.py)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True, help="bundle output directory")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer dir copied into <out>/tokenizer")
    p.add_argument("--qformer-tokenizer", default=None,
                   help="BERT tokenizer dir copied into "
                        "<out>/qformer_tokenizer")
    p.add_argument("--config", default=None,
                   help="JSON model-config override (scaled-down "
                        "checkpoints)")
    args = p.parse_args(argv)

    from ..scores.build import (
        VQA_CONVERSATIONS,
        config_from_dict,
        default_model_config,
        save_score_bundle,
    )

    cfg = default_model_config(args.name)
    if args.config:
        with open(args.config) as f:
            cfg = config_from_dict(type(cfg), json.load(f))
    params = convert_for_name(args.name, load_state_dict(args.checkpoint),
                              cfg)
    save_score_bundle(args.out, family=args.name, model_cfg=cfg,
                      params=params,
                      conversation=VQA_CONVERSATIONS.get(args.name))
    for src, sub in ((args.tokenizer, "tokenizer"),
                     (args.qformer_tokenizer, "qformer_tokenizer")):
        if src:
            dst = os.path.join(args.out, sub)
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(src, dst)
    print(f"bundle written: {args.out} "
          f"(use get_score_model({args.name!r}, checkpoint={args.out!r}))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
