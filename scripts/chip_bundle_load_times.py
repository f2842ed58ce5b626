#!/usr/bin/env python3
"""Where the seconds of one zoo family's bundle go on an NVIDIA GPU:

    python3 scripts/chip_bundle_load_times.py [family] [repeats]

Seeds ``family`` (default convnext_xxlarge, the largest of chip_smoke.py's
phase 20) on the card and times, ``repeats`` times (default 3): the write
(core/export.py save_model_bundle) split into the flax tree
(core/convert.py jax_params_from_clip: the copy to the host) and the
``.npz`` itself; the load (load_model_bundle's steps) split into reading
the ``.npz``, the state dict from the tree (state_dict_from_jax_params),
and the meta-device build with the copy to the card; and
core/factory.py create_model from the ``.npz``. Prints each reading, the
medians and the card's name and power limit. Exits with code 2 without a
CUDA device.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_bundle_load_times: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.core.convert import (
        jax_params_from_clip, state_dict_from_jax_params)
    from clip_embeds_tpu_torch.core.export import (
        WEIGHTS_NAME, save_model_bundle)
    from clip_embeds_tpu_torch.core.factory import (
        create_model, load_params_npz, save_params_npz)
    from clip_embeds_tpu_torch.models.clip import CLIP

    name = argv[0] if argv else "convnext_xxlarge"
    repeats = int(argv[1]) if len(argv) > 1 else 3
    gpu = cs.gpu_line()
    print(f"[device] {gpu} | torch {torch.__version__}")
    model = cs.zoo_clip(name, cs.Z20_SEED)
    cfg = model.cfg
    times = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(label, []).append(time.perf_counter() - t0)
        return out

    def to_card(sd):
        with torch.device("meta"):
            m = CLIP(cfg)
        m.load_state_dict(sd, assign=True)
        return m.to("cuda").eval()

    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "bundle")
        save_model_bundle(folder, model, name)
        path = os.path.join(folder, WEIGHTS_NAME)
        gib = os.path.getsize(path) / 2**30
        for _ in range(repeats):
            tree = timed("write: the flax tree", lambda: jax_params_from_clip(
                model))
            timed("write: the .npz", lambda: save_params_npz(tree, path))
            del tree
            tree = timed("load: read the .npz", lambda: load_params_npz(path))
            sd = timed("load: the state dict", lambda: (
                state_dict_from_jax_params(tree)))
            del tree
            loaded = timed("load: build, to the card", lambda: to_card(sd))
            del sd, loaded
            made = timed("create_model from the .npz", lambda: create_model(
                name, pretrained=path, device="cuda"))
            del made
            torch.cuda.empty_cache()
    for label, ts in times.items():
        each = ", ".join(f"{t:.2f}" for t in ts)
        print(f"[bundle times] {name} {label}: median "
              f"{statistics.median(ts):.2f} s ({each}) on {gpu}")
    print(f"[bundle times] {name}: the .npz {gib:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
