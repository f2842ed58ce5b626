"""The port as the benchmark builds it: the CLIP of a configuration file,
built as the port's entry points build it, with the benchmark's seeded
weights loaded into it. The only module of the harness that names the
port's model classes; the drivers call the port's entry points
themselves."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def port_config(config: Dict):
    """The port's ``CLIPConfig`` of ``config``: the registry's entry for
    the configuration's model and tag, with every size set from the file
    (at the published sizes that changes nothing; the tests build tiny
    ones the same way)."""
    from clip_embeds_tpu_torch.core.config import get_model_config

    cfg = get_model_config(config["port_model"], config.get("port_pretrained"))
    v, t = config["vision"], config["text"]
    vision = dataclasses.replace(
        cfg.vision, image_size=v["image_size"], patch_size=v["patch_size"],
        width=v["width"], layers=v["layers"],
        head_width=v["width"] // v["heads"],
        mlp_ratio=v["mlp_width"] / v["width"])
    text = dataclasses.replace(
        cfg.text, context_length=t["context_length"],
        vocab_size=t["vocab_size"], width=t["width"], heads=t["heads"],
        layers=t["layers"], mlp_ratio=t["mlp_width"] / t["width"])
    return cfg.replace(vision=vision, text=text, embed_dim=config["embed_dim"],
                       quick_gelu=t["act"] == "quick_gelu")


@torch.no_grad()
def build_clip(config: Dict, weights: Dict[str, torch.Tensor],
               device: torch.device, dtype: torch.dtype, train: bool = False,
               **kw) -> torch.nn.Module:
    """The port's CLIP with parameters in ``dtype`` on ``device`` holding
    ``weights``. Built on the meta device and given storage on ``device``,
    as ``core/factory.py create_model`` builds it (without the seeded
    init on the host that the loaded weights would overwrite); ``kw`` are
    the model's training options (``remat``, ``block_impl``,
    ``compute_dtype``)."""
    from clip_embeds_tpu_torch.models.clip import CLIP

    with torch.device("meta"):
        model = CLIP(port_config(config), **kw).to(dtype)
    model.to_empty(device=device)
    model.load_state_dict(dict(weights))
    return model.train(train)
