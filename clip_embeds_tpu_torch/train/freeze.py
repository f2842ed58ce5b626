"""Partial-tower freezing, LiT style (counterpart of
``clip_embeds_tpu/train/freeze.py``; open_clip ``lock_image_tower`` and
``Transformer.lock``).

* ``lock_image`` freezes the vision tower; ``lock_image_unlocked_groups``
  N leaves the LAST N groups trainable, of [embeddings (conv1, class and
  positional embeddings, ln_pre), resblocks 0 .. L-1, ln_post + proj].
* ``lock_text`` freezes the text tower; ``lock_text_unlocked_layers`` N
  leaves the last N resblocks plus ln_final / text_projection trainable;
  ``lock_text_freeze_layer_norm`` extends the freeze to the LayerNorm
  parameters of the locked part (without it they keep training).

Labels are 'train' or 'freeze' per parameter name (open_clip names: the
vision tower under ``visual.``, the text tower at top level).

The groups are the ViT's, as in JAX: a zoo tower's parameters all fall in
the embeddings group (ConvNeXt's linear head in the last, where JAX's
``proj`` name puts it), so ``lock_image_unlocked_groups`` leaves a zoo tower
frozen whole, head included, as JAX's labels do; ``cli/train.py`` refuses
the flag on a zoo tower (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Dict

from torch import nn

_TEXT_TOWER = {"token_embedding", "positional_embedding", "transformer",
               "ln_final", "text_projection"}
_FINAL_VISION_KEYS = {"ln_post", "proj"}
_FINAL_TEXT_KEYS = {"ln_final", "text_projection"}


def tower_freeze_labels(model: nn.Module, cfg, lock_image: bool = False,
                        lock_image_unlocked_groups: int = 0,
                        lock_text: bool = False,
                        lock_text_unlocked_layers: int = 0,
                        lock_text_freeze_layer_norm: bool = False
                        ) -> Dict[str, str]:
    """Parameter name -> 'train' | 'freeze'."""
    n_txt = cfg.text.layers
    vis_groups = cfg.vision.layers + 2
    # JAX's ConvNeXt names its linear head 'proj' at the tower's top, which
    # its labels take for the ViT's final group
    zoo_head = cfg.vision.tower == "convnext"
    first_trainable_vis_group = vis_groups - lock_image_unlocked_groups

    def vision_label(parts) -> str:
        if parts[1] == "transformer":
            group = 1 + int(parts[3])
        elif parts[1] in _FINAL_VISION_KEYS or (
                zoo_head and parts[1:3] == ["head", "proj"]):
            group = vis_groups - 1
        else:
            group = 0
        return "train" if group >= first_trainable_vis_group else "freeze"

    def text_label(parts) -> str:
        if parts[0] in _FINAL_TEXT_KEYS:
            unlocked = lock_text_unlocked_layers > 0
        elif parts[0] == "transformer":
            unlocked = int(parts[2]) >= n_txt - lock_text_unlocked_layers
        else:
            unlocked = False
        if not unlocked and not lock_text_freeze_layer_norm and any(
                k.startswith("ln_") for k in parts):
            return "train"  # LayerNorms keep training unless asked
        return "train" if unlocked else "freeze"

    labels = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if lock_image and parts[0] == "visual":
            labels[name] = vision_label(parts)
        elif lock_text and parts[0] in _TEXT_TOWER:
            labels[name] = text_label(parts)
        else:
            labels[name] = "train"
    return labels


def apply_freeze(model: nn.Module, labels: Dict[str, str]) -> int:
    """``requires_grad=False`` on every 'freeze' parameter (they stay out
    of the optimizer and the gradient norm); returns how many."""
    frozen = 0
    for name, p in model.named_parameters():
        if labels[name] == "freeze":
            p.requires_grad_(False)
            frozen += 1
    return frozen
