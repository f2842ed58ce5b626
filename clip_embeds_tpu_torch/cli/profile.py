"""FLOP and parameter profiler (counterpart of
``clip_embeds_tpu/cli/profile.py``; open_clip's ``profiler.py``): one CSV
row a model with JAX's columns (model, image_size, image_width,
text_width, embed_dim, mparams, gflops, image_gflops, text_gflops).

  python -m clip_embeds_tpu_torch.cli.profile --model ViT-B-32 EVA01-g-14 \\
      [--results-file rows.csv] [--trace DIR] [--device cuda]

The counts need no device: the model is built on the meta device (no
memory), and ``torch.utils.flop_counter.FlopCounterMode`` counts one
forward at batch 1 (both towers; each tower alone). It counts the matrix
products and convolutions, 2 M N K each, as open_clip's profiler does;
XLA's ``cost_analysis``, which the JAX command reads, also counts the
elementwise work, so JAX's ``gflops`` is larger by a held ratio
(``tests/test_torch_profile_cli.py``). ``mparams`` counts what JAX
counts: the parameters, and ModifiedResNet's BatchNorm statistics, which
JAX holds as parameters. ``--trace DIR`` also writes a ``torch.profiler``
Chrome trace of 3 warm forward steps at ``--trace-batch-size`` on
``--device`` (the card by default; without one it exits) to
``DIR/<model>/trace.json``. The trace shows the port's own spans
(``core/tracing.py``; here ``tower.image`` and ``tower.text``, one a tower
call) as ranges above the operators and kernels each launched; any torch
profiler session around the port's entry points and train steps records
them the same way (``embed.*``, ``train.*``).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Dict


def count_params(model) -> int:
    """The entries JAX's parameter tree holds for ``model``: its
    parameters and the BatchNorm statistics (JAX's FrozenBatchNorm
    ``mean`` / ``var``)."""
    n = sum(p.numel() for p in model.parameters())
    return n + sum(b.numel() for name, b in model.named_buffers()
                   if name.endswith(("running_mean", "running_var")))


def _meta_model(name: str):
    """``name``'s CLIP on the meta device: shapes, no storage."""
    import torch

    from ..core.config import get_model_config
    from ..models.clip import CLIP

    with torch.device("meta"):
        return CLIP(get_model_config(name)).eval()


def _flops(fn, *args) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops())


def profile_model(name: str) -> Dict[str, object]:
    """The CSV row of ``name``."""
    import torch

    model = _meta_model(name)
    cfg = model.cfg
    s = cfg.vision.image_size
    images = torch.zeros(1, s, s, 3, device="meta")
    texts = torch.zeros(1, cfg.text.context_length, dtype=torch.long,
                        device="meta")
    return {
        "model": name,
        "image_size": s,
        "image_width": cfg.vision.width,
        "text_width": cfg.text.width,
        "embed_dim": cfg.embed_dim,
        "mparams": round(count_params(model) / 1e6, 2),
        "gflops": round(_flops(model, images, texts) / 1e9, 2),
        "image_gflops": round(_flops(model.encode_image, images) / 1e9, 2),
        "text_gflops": round(_flops(model.encode_text, texts) / 1e9, 2),
    }


def capture_trace(name: str, trace_dir: str, device, batch_size: int = 8,
                  steps: int = 3, dtype=None) -> str:
    """A ``torch.profiler`` Chrome trace of ``steps`` forward steps of a
    seeded ``name`` at ``batch_size`` on ``device`` (bf16 on the card,
    fp32 elsewhere), after one warm-up step outside it; returns the trace
    file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core.factory import create_model

    dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                      else torch.float32)
    model = create_model(name, seed=0, dtype=dtype, device=device)
    cfg = model.cfg
    s = cfg.vision.image_size
    images = torch.zeros(batch_size, s, s, 3, device=device, dtype=dtype)
    texts = torch.zeros(batch_size, cfg.text.context_length,
                        dtype=torch.long, device=device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.inference_mode():
        model(images, texts)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with profile(activities=activities) as prof:
            for _ in range(steps):
                model(images, texts)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser("clip_embeds_tpu_torch profiler")
    p.add_argument("--model", nargs="+", default=["ViT-B-32"])
    p.add_argument("--results-file", default=None)
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="also write a torch.profiler trace of each model's "
                        "forward to DIR/<model>/trace.json")
    p.add_argument("--trace-batch-size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="where --trace runs: 'cuda' (the default: exits if "
                        "there is no card) or 'cpu'")
    args = p.parse_args(argv)

    if args.trace:
        from ..core.factory import resolve_device

        device = resolve_device(args.device)
    rows = [profile_model(name) for name in args.model]
    if args.trace:
        for name in args.model:
            path = capture_trace(
                name, os.path.join(args.trace, name.replace("/", "-")),
                device, args.trace_batch_size)
            print(f"trace for {name}: {path}", file=sys.stderr)
    out = open(args.results_file, "w") if args.results_file else sys.stdout
    writer = csv.DictWriter(out, fieldnames=list(rows[0]))
    writer.writeheader()
    writer.writerows(rows)
    if args.results_file:
        out.close()
    return rows


if __name__ == "__main__":
    main()
