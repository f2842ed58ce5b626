"""Seeded weights of a configuration, made on the device in one draw.

One normal draw of every parameter's values (in ``reference/towers.py
param_specs`` order) from a generator on the device, cut into the
parameters and scaled by kind: matrices at fan-in^-1/2, the last layer of
each residual branch also by (2 layers)^-1/2 (open_clip's init; PR 17 of
the port found the zoo towers need it), embeddings at their own std,
biases and LayerNorm shifts at 0.02, LayerNorm gains 1 + 0.02 x draw, the
logit scale ln(1 / 0.07). Both sides get the same dict: the port through
``load_state_dict``, the reference as it is (upcast to fp32).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.towers import param_specs
from .seeds import torch_generator

SMALL = 0.02


@torch.no_grad()
def make_weights(config: Dict, seed: int, device: torch.device,
                 dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """name -> tensor of ``dtype`` on ``device``; the same ``seed`` gives the
    same values on the same kind of device."""
    specs = param_specs(config)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    g = torch_generator(seed, "weights", device)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind, std in specs:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if kind in ("matrix", "branch_end", "embed"):
            x.mul_(std)
        elif kind in ("bias", "ln_b"):
            x.mul_(SMALL)
        elif kind == "ln_w":
            x.mul_(SMALL).add_(1.0)
        elif kind == "scale":
            x.fill_(math.log(1 / 0.07))
        else:
            raise ValueError(f"{name}: kind {kind!r}")
        out[name] = x
    if dtype != torch.float32:
        flat = flat.to(dtype)
        at = 0
        for name, shape, _, _ in specs:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape)
            at += n
    return out
