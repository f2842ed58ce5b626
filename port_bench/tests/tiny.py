"""Tiny configurations and traffic for the CPU tests: the cells' files
with every size cut, and the same keys."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(*parts):
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


TEXT = dict(context_length=16, vocab_size=512, width=32, heads=2, layers=2,
            mlp_width=128, sot_id=510, eot_id=511)


def config(name: str) -> dict:
    c = copy.deepcopy(_read("configs", name + ".json"))
    if c["vision"]["tower"] == "vit":
        c["vision"].update(image_size=32, patch_size=8, width=64, layers=2,
                           heads=4, mlp_width=256)
    else:
        c["vision"].update(image_size=28, patch_size=14, width=64, layers=2,
                           heads=4, mlp_width=176)
    c["text"].update(TEXT)
    c["embed_dim"] = 48
    return c


def traffic(name: str) -> dict:
    t = copy.deepcopy(_read("traffic", name + ".json"))
    t["batch"] = 8
    t["len_min"], t["len_max"] = 3, 12
    if t.get("hard_texts"):
        t["hard_texts"] = 2
    t["pool_batches"] = min(t["pool_batches"], 4)
    t["warmup_calls"] = 1
    t["warm_steps"] = 1
    t["ref_chunk"] = 4
    return t
