"""MMEB embedding-retrieval evaluation entry point (counterpart of
``clip_embeds_tpu/cli/eval_mmeb.py``; reference ``VLM2Vec/eval.py``): per
subset, encode the deduplicated query and target sides with the LLaVA
bi-encoder (last-token pooling), cache the embeddings under
``--encode_output_path``, score each query against its candidate targets
(gold first: prediction 0 is correct), and report per-subset and average
accuracy. The arguments are the reference's dataclasses
(``train/arguments.py``), plus ``--device`` (default ``cuda``: an error
without a card unless given ``--device cpu``).

Data: ``--dataset_name`` is a directory holding one ``<subset>.json[l]``
per ``--subset_name``, rows {"qry_text", "qry_img_path", "tgt_text":
[...], "tgt_img_path": [...]} (TIGER-Lab/MMEB-eval's schema; image paths
relative to ``--image_dir``).

``--model_name`` is a score bundle (config.json + params.npz [+
tokenizer/]); without one a tiny seeded model runs. ``--checkpoint_path``
may name an adapter ``.npz`` of ``cli/train_vlm2vec.py``: merged into the
base with ``--lora`` (peft ``merge_and_unload``), served unmerged through
the side-path with ``--quant_base`` (the W8A8 trunk, ``int8_linear`` on
the card), where a key that matches no layer is an error.

  python -m clip_embeds_tpu_torch.cli.eval_mmeb --model_name BUNDLE \
      --checkpoint_path adapter-final.npz --lora --dataset_name DIR \
      --subset_name A B --image_dir DIR/images --encode_output_path OUT

``main`` logs the table as the JAX CLI does, writes ``results.json``
under ``--encode_output_path``, and returns ``({"subsets": ...,
"average": ...}, report)``; the report holds the embedded items, the
seconds and the items/s.
"""

from __future__ import annotations

import json
import logging
import os
import time


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("eval_mmeb")

    import numpy as np
    import torch

    from ..core.factory import resolve_device
    from ..evals.mmeb import evaluate_subset, make_embedding_encoders
    from ..scores.embedding_scorer import EmbeddingScorer
    from ..train.arguments import (DataArguments, ModelArguments,
                                   TrainingArguments, parse_dataclasses)
    from .train_vlm2vec import _load_subset_rows, load_base, split_device

    device_arg, argv = split_device(argv)
    model_args, data_args, training_args = parse_dataclasses(
        [ModelArguments, DataArguments, TrainingArguments], argv)
    device = resolve_device(device_arg)
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32
    bundle = model_args.model_name
    if not (bundle and os.path.isdir(bundle)):
        log.info("no --model_name bundle: tiny seeded model (smoke)")
        bundle = None
    lora_kw = {}
    if model_args.quant_base:
        # adapters (if any) served unmerged: int8 weights cannot absorb
        # merged fp deltas
        lora_kw = dict(lora_rank=model_args.lora_r,
                       lora_alpha=float(model_args.lora_alpha))
    cfg, model, (tokenize, bos_id, pad_id) = load_base(
        bundle, 0, device, dtype, quant=model_args.quant_base, **lora_kw)
    if model_args.quant_base:
        log.info("--quant_base: W8A8 trunk")

    adapter = model_args.checkpoint_path
    lora_tree = None
    if adapter and adapter.endswith(".npz"):
        with np.load(adapter) as data:
            lora = {k: data[k] for k in data.files}
        if model_args.quant_base:
            lora_tree = lora
            log.info("serving LoRA adapter %s unmaterialized (alpha %d)",
                     adapter, model_args.lora_alpha)
        else:
            from ..models.lora import merge_lora

            model = merge_lora(model, lora,
                               alpha=float(model_args.lora_alpha))
            log.info("merged LoRA adapter %s (alpha %d)", adapter,
                     model_args.lora_alpha)

    scorer = EmbeddingScorer(
        model, tokenize, bos_token_id=bos_id, pad_token_id=pad_id,
        batch_size=training_args.per_device_train_batch_size,
        max_len=data_args.max_len, lora=lora_tree)
    encode_queries, encode_targets = make_embedding_encoders(scorer)
    items = [0]

    def counted(encode):
        def run(pairs):
            items[0] += len(pairs)
            return encode(pairs)
        return run

    root = data_args.dataset_name
    image_dir = data_args.image_dir or ""
    cache_dir = data_args.encode_output_path
    results = {}
    t0 = time.perf_counter()
    for sub in data_args.subset_name or []:
        for ext in (".json", ".jsonl"):
            path = os.path.join(root, sub + ext)
            if os.path.exists(path):
                break
        else:
            raise FileNotFoundError(f"no {sub}.json[l] under {root}")
        rows = _load_subset_rows(path)

        def join(p):
            return os.path.join(image_dir, p) if p else ""

        rows = [
            {
                "qry_text": r["qry_text"],
                "qry_img_path": join(r.get("qry_img_path", "")),
                "tgt_text": list(r["tgt_text"]),
                "tgt_img_path": [join(p) for p in r.get(
                    "tgt_img_path", [""] * len(r["tgt_text"]))],
            }
            for r in rows
        ]
        res = evaluate_subset(
            rows, counted(encode_queries), counted(encode_targets),
            cache_dir=cache_dir, subset=sub)
        results[sub] = res
        log.info("%s: acc %.4f (%d/%d)", sub, res["acc"],
                 res["num_correct"], res["num_pred"])
    seconds = time.perf_counter() - t0

    table = {"subsets": results, "average": None}
    if results:
        avg = sum(r["acc"] for r in results.values()) / len(results)
        table["average"] = avg
        log.info("average accuracy over %d subsets: %.4f", len(results), avg)
        if cache_dir:
            with open(os.path.join(cache_dir, "results.json"), "w") as fh:
                json.dump({"subsets": results, "average": avg}, fh, indent=1)
    report = {"items": items[0], "seconds": seconds,
              "items_per_s": items[0] / seconds if seconds else None}
    log.info("embedded %d items in %.2f s", items[0], seconds)
    return table, report


if __name__ == "__main__":
    main()
