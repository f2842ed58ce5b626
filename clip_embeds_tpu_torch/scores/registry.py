"""Score-model name registry, the t2v_metrics dispatch surface (a copy of
``clip_embeds_tpu/scores/registry.py``: the name tables, ``list_all_*`` and
``get_score_model``).

CLIPScore names follow the '<pretrained>:<arch>' format over the registry's
pretrained table; the port builds those of its hand-written configs. The
VQA, ITM and BLIP-2 ITC families need converted weights (a score bundle,
see ``scores/build.py``): LLaVA, CLIP-FlanT5, InstructBLIP-FlanT5, BLIP-2
ITM / ITC and ImageReward; GPT-4V needs its transport passed in. Models
are placed on ``device`` (default the card).
"""

from __future__ import annotations

from typing import List, Optional

# vqascore_models name tables
LLAVA_MODELS = [
    "llava-v1.5-13b", "llava-v1.5-7b", "sharegpt4v-7b", "sharegpt4v-13b",
]
LLAVA_LLAMA_MODELS = ["llava-phi-3", "llava-llama-3"]
LLAVA16_MODELS = ["llava-v1.6-13b"]
CLIP_T5_MODELS = [
    "clip-flant5-xxl", "clip-flant5-xl",
    "clip-flant5-xxl-no-system", "clip-flant5-xxl-no-system-no-user",
]
INSTRUCTBLIP_MODELS = ["instructblip-flant5-xxl", "instructblip-flant5-xl"]
GPT4V_MODELS = ["gpt-4-turbo", "gpt-4o"]

BLIP2_ITC_MODELS = ["blip2-itc", "blip2-itc-vitL", "blip2-itc-coco"]
HPSV2_MODELS = ["hpsv2"]
PICKSCORE_MODELS = ["pickscore-v1"]
BLIP2_ITM_MODELS = ["blip2-itm", "blip2-itm-vitL", "blip2-itm-coco"]
IMAGE_REWARD_MODELS = ["image-reward-v1"]

# Alias -> (CLIP arch, preprocess variant): HPSv2 and PickScore_v1 are
# tuned ViT-H-14 towers scored by the normalized-feature dot product, with
# open_clip's shortest-edge + center-crop + OpenAI-stats preprocessing
CLIPSCORE_ALIASES = {
    "hpsv2": ("ViT-H-14", "clip"),
    "pickscore-v1": ("ViT-H-14", "clip"),
}


def list_all_vqascore_models() -> List[str]:
    return (LLAVA_MODELS + LLAVA_LLAMA_MODELS + LLAVA16_MODELS
            + CLIP_T5_MODELS + INSTRUCTBLIP_MODELS + GPT4V_MODELS)


def list_all_clipscore_models() -> List[str]:
    from ..core.openclip_registry import list_pretrained

    clip = [f"{tag}:{arch}" for arch, tag in list_pretrained()]
    return clip + BLIP2_ITC_MODELS + HPSV2_MODELS + PICKSCORE_MODELS


def list_all_itmscore_models() -> List[str]:
    return BLIP2_ITM_MODELS + IMAGE_REWARD_MODELS


def list_all_models() -> List[str]:
    return (list_all_vqascore_models() + list_all_clipscore_models()
            + list_all_itmscore_models())


def _clip_score(arch: str, pretrained: Optional[str], device, **kwargs):
    import torch

    from ..core.factory import create_model, resolve_device
    from .score import CLIPScore

    model = create_model(arch, pretrained, dtype=torch.bfloat16,
                         device=resolve_device(str(device)))
    return CLIPScore(model, **kwargs)


def get_score_model(
    model: str = "clip-flant5-xxl",
    checkpoint: Optional[str] = None,
    device: str = "cuda",
    **kwargs,
):
    """Resolve a score-model name to a live Score.

    CLIP-family '<tag>:<arch>' names build immediately (seeded random
    weights when the checkpoint is absent). The VQA/ITM families require
    converted weights: without a ``checkpoint`` this raises naming what to
    pass."""
    if ":" in model:
        tag, arch = model.split(":", 1)
        return _clip_score(arch, checkpoint or tag, device, **kwargs)
    if model in GPT4V_MODELS or model in (
        list_all_vqascore_models() + list_all_itmscore_models()
        + BLIP2_ITC_MODELS
    ):
        from .build import build_score_model

        if model in GPT4V_MODELS or checkpoint is not None:
            return build_score_model(model, checkpoint, device=device,
                                     **kwargs)
        raise NotImplementedError(
            f"{model!r} needs converted weights (no downloads here): "
            "convert the checkpoint, write a bundle with "
            "scores.build.save_score_bundle, and pass "
            "checkpoint=<bundle dir>"
        )
    if model in HPSV2_MODELS + PICKSCORE_MODELS:
        arch, variant = CLIPSCORE_ALIASES[model]
        return _clip_score(arch, checkpoint, device,
                           preprocess_variant=variant, **kwargs)
    raise KeyError(f"unknown score model {model!r}")
