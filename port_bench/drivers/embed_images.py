"""Image embedding as ``cli/embed.py`` serves it: ``embed_image_batches``
over preprocessed float32 batches staged in host memory, the program's own
pinned copy to the card, the composable tower (flash attention #4 in bf16)
and the single fetch of every embedding at the end (``embedding.py``).
Every returned row is judged against the fp32 reference on the same pixels
and weights."""

from __future__ import annotations

import torch

from port_bench import check, embedding
from port_bench.harness import Bench
from port_bench.inputs import image_batches
from port_bench.reference.towers import encode_image
from port_bench.weights import make_weights

BLOCK = 32   # images a block of the reference


def pool_of(bench: Bench):
    t = bench.traffic
    dev = image_batches(bench.config, t["pool_batches"], t["batch"],
                        bench.seed, "embed_images", bench.device)
    return [x.cpu().numpy() for x in dev]


def reference(bench: Bench, pool, mm=torch.matmul) -> torch.Tensor:
    """The fp32 reference's embeddings of every pool image, in pool order,
    on the device."""
    dtype = getattr(torch, bench.traffic["dtype"])
    with check.fp32_reference(), torch.no_grad():
        w = {k: v.float() for k, v in make_weights(
            bench.config, bench.seed, bench.device, dtype).items()}
        out = [encode_image(w, bench.config, torch.from_numpy(
            x[i:i + BLOCK]).to(bench.device), mm)
            for x in pool for i in range(0, len(x), BLOCK)]
    return torch.cat(out)


def run(bench: Bench) -> dict:
    from clip_embeds_tpu_torch.cli import embed

    return embedding.run(bench, embed.embed_image_batches, embed.image_route,
                         pool_of, reference)


def control(bench: Bench, kind: str = "int8") -> dict:
    from clip_embeds_tpu_torch.cli import embed

    return embedding.control(bench, kind, embed.embed_image_batches,
                             pool_of, reference)
