"""Caption embedding as ``cli/embed.py`` serves it: ``embed_text_batches``
over tokenised [batch, 77] batches staged in host memory; on the card in
bf16 the 'fused' route (``fused_encode_text``, the #1 fused-block chain),
with the window and the check of every returned row of ``embedding.py``."""

from __future__ import annotations

import torch

from port_bench import check, embedding
from port_bench.harness import Bench
from port_bench.inputs import token_batches
from port_bench.reference.towers import encode_text
from port_bench.weights import make_weights

BLOCK = 256   # captions a block of the reference


def pool_of(bench: Bench):
    t = bench.traffic
    return token_batches(bench.config, t["pool_batches"], t["batch"],
                         t["len_min"], t["len_max"], bench.seed,
                         "embed_texts")


def reference(bench: Bench, pool, mm=torch.matmul) -> torch.Tensor:
    """The fp32 reference's embeddings of every pool caption, in pool
    order, on the device."""
    dtype = getattr(torch, bench.traffic["dtype"])
    with check.fp32_reference(), torch.no_grad():
        w = {k: v.float() for k, v in make_weights(
            bench.config, bench.seed, bench.device, dtype).items()}
        out = [encode_text(w, bench.config, torch.from_numpy(
            x[i:i + BLOCK]).to(bench.device), mm)
            for x in pool for i in range(0, len(x), BLOCK)]
    return torch.cat(out)


def run(bench: Bench) -> dict:
    from clip_embeds_tpu_torch.cli import embed

    return embedding.run(bench, embed.embed_text_batches, embed.text_route,
                         pool_of, reference)


def control(bench: Bench, kind: str = "int8") -> dict:
    from clip_embeds_tpu_torch.cli import embed

    return embedding.control(bench, kind, embed.embed_text_batches,
                             pool_of, reference)
