"""VLM2Vec embedding-training entry point (counterpart of
``clip_embeds_tpu/cli/train_vlm2vec.py``; reference ``VLM2Vec/train.py``
with scripts/llava_1.5/run_train.sh): LLaVA-1.5 turned into an embedding
model by last-token pooling, trained with LoRA, the in-batch contrastive
loss (T = 0.02) and optionally GradCache. The arguments are the
reference's dataclasses (``train/arguments.py``), plus ``--device``
(default ``cuda``: an error without a card unless given ``--device cpu``).

Data routes (local files only):
  --dataset_name <dir> --subset_name A B ...   MMEB-style training: each
      subset is <dir>/<name>.json[l] with rows {qry, qry_image_path,
      pos_text, pos_image_path}; mixed batches (any row on either side may
      carry an image) through ``data/mmeb.py mixed_pair_batches`` and
      ``Llava.embed_mixed``.
  --dataset_name <pretrain.json> [--subset_name <instruct.json>]   the
      Combined 558K + 665K route (query = question + image, target =
      answer) through ``pair_batches``; it trains adapters (--lora).
  --dataset_name omitted   synthetic mixed batches (64 tokens a row).

``--checkpoint_path`` is a score bundle (``scores/build.py`` layout);
omitted, a tiny seeded LLaVA runs the recipe. Without a bundle tokenizer
the crc32 word-hash ``_toy_tokenize`` tokenises. ``--lora`` trains
materialized adapters over the frozen base; ``--quant_base`` freezes the
trunk as W8A8 (``int8_linear`` on the card) and trains the adapters
through the unmaterialized side-path, with each trunk block recomputed in
the backward. Without ``--lora`` the whole model trains (mixed routes;
fp32 only, as full fine-tuning keeps fp32 weights). The adapter tree is
saved as ``adapter-<step>.npz`` every ``--save_steps`` and at the end
(the JAX layout), and after a ``--lora`` run over an fp base the merged
model as a score bundle under ``<output_dir>/merged``.

``main`` returns ``(state, report)``: the report holds the losses, the
samples/s of each logged step and the peak device memory (GiB, on the
card). Many cards: one process a card under ``torchrun``; ``--data_parallel
N`` (-1: every rank) makes the global batch ``per_device_train_batch_size``
x N, as in JAX, each rank encoding its rows and the loss taking its
negatives from the gathered representations; the adapters' (or the whole
model's) gradients are averaged over the ranks, and rank 0 logs and saves.
``--model_parallel M`` lays the ranks out as JAX's (data, model) mesh of
N x M (``--data_parallel -1``: world // M) and, as JAX, shards nothing over
the model axis: every rank holds the whole trunk, the M ranks of a model
group draw the same rows, and the global batch stays per-device x N; the
gradients averaged over all the ranks are JAX's replicated step's.

  python -m clip_embeds_tpu_torch.cli.train_vlm2vec --lora --lora_r 16 \
      --grad_cache --gc_q_chunk_size 2 --per_device_train_batch_size 64 \
      --max_steps 1000 --output_dir /ckpt/vlm2vec [--quant_base]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _load_subset_rows(path: str):
    """Rows from a .json (list) or .jsonl file."""
    if path.endswith(".jsonl"):
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]
    with open(path) as fh:
        return json.load(fh)


def _toy_tokenize(text: str):
    """Deterministic fallback tokenizer for synthetic/smoke runs (no
    bundle tokenizer): crc32-hashed whitespace tokens over a small vocab
    (crc32, not hash(): the latter changes with PYTHONHASHSEED)."""
    import zlib

    return [1] + [2 + (zlib.crc32(w.encode()) % 97) for w in text.split()]


def _synthetic_mixed_batches(
    batch_size: int, image_size: int, seed: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Random mixed batches with ``data/mmeb.py mixed_pair_batches``'s keys:
    64 tokens a row, images on 0.8 of the queries and 0.3 of the
    targets."""
    from ..models.llava import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(seed)
    ln = 64
    while True:
        out = {}
        for prefix in ("qry", "tgt"):
            ids = rng.integers(2, 90, (batch_size, ln)).astype(np.int32)
            mask = np.zeros((batch_size, ln), bool)
            valid = rng.random(batch_size) < (0.8 if prefix == "qry" else 0.3)
            for i in range(batch_size):
                n_real = int(rng.integers(8, ln - 1))
                ids[i, n_real:] = 0
                ids[i, n_real - 1 if valid[i] else ln - 1] = IMAGE_TOKEN_INDEX
                mask[i, : n_real - (1 if valid[i] else 0)] = True
                if valid[i]:
                    mask[i, n_real - 1] = True  # sentinel is a real position
            out[f"{prefix}_ids"] = ids
            out[f"{prefix}_mask"] = mask
            out[f"{prefix}_pixels"] = rng.standard_normal(
                (batch_size, image_size, image_size, 3)
            ).astype(np.float32)
            out[f"{prefix}_image_valid"] = valid
        yield out


def split_device(argv):
    """(device name, the rest of argv): ``--device`` is the port's own
    flag beside the reference's dataclass fields."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    ns, rest = p.parse_known_args(argv)
    return ns.device, rest


def data_ranks(training_args) -> Tuple[int, int]:
    """(n_dp, n_mp): the mesh the flags ask for, JAX's sizing
    (``--data_parallel -1``: the world over ``--model_parallel``). A world
    other than n_dp x n_mp exits."""
    import torch.distributed as dist

    n_mp = max(training_args.model_parallel, 1)
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", 1))
    n_dp = training_args.data_parallel
    n_dp = max(world // n_mp if n_dp == -1 else n_dp, 1)
    if n_dp * n_mp != world:
        raise ValueError(f"--data_parallel {n_dp} with {world} rank(s) "
                         "running: start one rank a card with torchrun")
    return n_dp, n_mp


def load_base(ckpt, seed, device, dtype, quant=False, **llava_kw):
    """(cfg, model, (tokenize, bos, pad)): the LLaVA of the score bundle
    ``ckpt`` with its tokenizer, or (``ckpt`` None) the tiny one seeded
    with ``seed`` and the toy tokenizer; frozen, on ``device`` in
    ``dtype``. With ``quant`` the trunk is W8A8 (dynamic), quantised from
    the fp32 weights (a bundle's) or the model's own; ``llava_kw``
    (``lora_rank``, ``lora_alpha``, ``remat``) go to that model."""
    from ..core.factory import init_llava
    from ..models.llava import LlavaConfig, llava_tiny_config
    from ..models.quant import quantize_llava_trunk
    from ..scores.build import (config_from_dict, llava_from_params,
                                load_score_bundle)
    from ..scores.vqa_score import hf_tokenizer_adapter

    log = logging.getLogger("vlm2vec")
    tok = (_toy_tokenize, 1, 0)
    if ckpt:
        meta, params = load_score_bundle(ckpt)
        cfg = config_from_dict(LlavaConfig, meta.get("model", {}))
        model = llava_from_params(params, cfg, device, dtype, quant=quant,
                                  **llava_kw)
        tok_dir = os.path.join(ckpt, "tokenizer")
        if os.path.isdir(tok_dir):
            from transformers import AutoTokenizer

            tok = hf_tokenizer_adapter(AutoTokenizer.from_pretrained(tok_dir))
        else:
            log.warning("bundle %s has NO tokenizer/ subdir — falling back "
                        "to the toy hashed tokenizer; real-checkpoint runs "
                        "with it produce garbage", ckpt)
        return cfg, model, tok
    log.info("no checkpoint: tiny seeded LLaVA (smoke run)")
    model = init_llava(llava_tiny_config(), seed=seed, device=device,
                       dtype=dtype)
    if quant:
        model = quantize_llava_trunk(model, "dynamic", **llava_kw)
    return model.cfg, model.requires_grad_(False), tok


def to_device(batch: Dict[str, np.ndarray], device, dtype):
    """A numpy batch on ``device``: int ids as int64, masks as bool, pixels
    in the model's dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        elif t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def save_merged(path: str, cfg, merged) -> None:
    """The merged model as a score bundle in the JAX layout (fp32
    params.npz), ready for ``build_score_model`` and ``cli/eval_mmeb.py``."""
    from ..core.convert import jax_params_from_module
    from ..scores.build import save_score_bundle

    save_score_bundle(path, "llava", cfg, jax_params_from_module(merged),
                      conversation="chat")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("vlm2vec")

    from ..parallel import mesh as pmesh
    from ..train.arguments import (DataArguments, ModelArguments,
                                   TrainingArguments, parse_dataclasses)

    device_arg, argv = split_device(argv)
    model_args, data_args, training_args = parse_dataclasses(
        [ModelArguments, DataArguments, TrainingArguments], argv)
    route = ("quant_base" if model_args.quant_base else
             "lora" if model_args.lora else "full")
    n_dp, n_mp = data_ranks(training_args)
    opened = n_dp * n_mp > 1 and not pmesh.distributed()
    try:
        return _train(log, device_arg, model_args, data_args, training_args,
                      route, n_dp, n_mp)
    finally:
        if opened:
            pmesh.close_distributed()


def _train(log, device_arg, model_args, data_args, training_args, route,
           n_dp, n_mp):
    from ..core.factory import resolve_device
    from ..models.lora import init_lora, lora_tensors, merge_lora
    from ..parallel import mesh as pmesh
    from ..parallel.sharding_rules import allreduce_grads
    from ..train.optim import adamw_over
    from ..train.schedules import const_lr, cosine_lr, linear_lr
    from ..train.vlm2vec import (Vlm2VecState, make_vlm2vec_mixed_train_step,
                                 make_vlm2vec_train_step)

    if n_dp * n_mp > 1:
        device = pmesh.init_distributed(device_arg)
        # the trunk stays whole on every rank: the model axis only repeats
        # each data rank's rows, as JAX's replicated state does
        pmesh.create_mesh(n_dp, n_mp)
        main_rank = torch.distributed.get_rank() == 0
    else:
        device = resolve_device(device_arg)
        main_rank = True
    rank = pmesh.data_rank()
    if not main_rank:
        log.setLevel(logging.WARNING)
    dtype = torch.bfloat16 if training_args.bf16 else torch.float32
    if model_args.quant_base and not model_args.lora:
        raise ValueError("--quant_base requires --lora (the int8 trunk is "
                         "frozen; only adapters train)")
    if not model_args.lora and training_args.bf16:
        raise ValueError("full fine-tuning keeps fp32 weights: pass "
                         "--no_bf16 (bf16 compute over fp32 masters is not "
                         "ported for LLaVA)")

    # -- model ----------------------------------------------------------------
    quant = dict(lora_rank=model_args.lora_r,
                 lora_alpha=float(model_args.lora_alpha), remat=True)
    cfg, model, (tokenize, bos_id, pad_id) = load_base(
        model_args.checkpoint_path, training_args.seed, device, dtype,
        quant=model_args.quant_base,
        **(quant if model_args.quant_base else {}))
    if model_args.quant_base:
        log.info("--quant_base: W8A8 trunk + unmaterialized LoRA r=%d",
                 model_args.lora_r)

    # -- data: the global batch is per_device x n_dp (the reference's
    # torchrun semantics, JAX's sizing); each rank keeps its rows ----------
    local_bs = training_args.per_device_train_batch_size
    bs = local_bs * n_dp
    if n_dp > 1:
        log.info("global batch %d = %d per device x %d data-parallel",
                 bs, local_bs, n_dp)
    if n_mp > 1:
        log.info("mesh %d x %d: the model axis holds whole replicas",
                 n_dp, n_mp)
    image_size = cfg.vision.image_size
    name = data_args.dataset_name
    if name is None:
        batches = _synthetic_mixed_batches(bs, image_size, training_args.seed)
    elif os.path.isdir(name):
        from ..data.mmeb import MMEBTrainDataset, mixed_pair_batches

        subsets = {}
        for sub in data_args.subset_name or []:
            for ext in (".json", ".jsonl"):
                p = os.path.join(name, sub + ext)
                if os.path.exists(p):
                    subsets[sub] = _load_subset_rows(p)
                    break
            else:
                raise FileNotFoundError(f"no {sub}.json[l] under {name}")
        ds = MMEBTrainDataset(
            subsets, image_dir=data_args.image_dir or name,
            num_sample_per_subset=data_args.num_sample_per_subset,
            model_backbone=model_args.model_backbone)
        log.info("MMEB train set: %d rows over %d subsets", len(ds),
                 len(subsets))

        def batches_epochs():
            epoch = 0
            while True:
                yield from mixed_pair_batches(
                    ds, tokenize, bs, bos_token_id=bos_id,
                    pad_token_id=pad_id, max_len=data_args.max_len,
                    image_size=image_size, seed=training_args.seed + epoch)
                epoch += 1

        batches = batches_epochs()
    else:
        from ..data.mmeb import CombinedPairDataset, pair_batches

        instruct = (data_args.subset_name or [None])[0]
        ds = CombinedPairDataset(name, instruct, data_args.image_dir or "",
                                 seed=training_args.seed)
        log.info("Combined pair set: %d samples", len(ds))

        def batches_epochs():
            epoch = 0
            while True:
                yield from pair_batches(
                    ds, tokenize, bs, bos_token_id=bos_id,
                    pad_token_id=pad_id, max_len=data_args.max_len,
                    image_size=image_size, seed=training_args.seed + epoch)
                epoch += 1

        batches = batches_epochs()
    mixed = name is None or os.path.isdir(name)
    if not mixed and not model_args.lora:
        raise ValueError(
            "the Combined pair route trains LoRA adapters (pass --lora)")

    # -- trainable tree + optimizer -------------------------------------------
    if model_args.lora:
        g = torch.Generator(device=device).manual_seed(training_args.seed + 1)
        trainable = init_lora(model, rank=model_args.lora_r, generator=g,
                              targets=model_args.lora_targets)
        tensors = list(lora_tensors(trainable))
        for t in tensors:
            t.requires_grad_()
        log.info("LoRA adapters on %d kernels (r=%d, alpha=%d)",
                 len(trainable), model_args.lora_r, model_args.lora_alpha)
    else:
        trainable = model.requires_grad_(True).train()
        if training_args.image_encoder_freeze:
            # a true freeze: JAX's optax.masked passes the raw gradient
            # through as the tower's update (ROADMAP.md queue 3)
            model.vision_tower.requires_grad_(False)
            log.info("--image_encoder_freeze: vision tower frozen")
        tensors = [p for p in model.parameters() if p.requires_grad]
    total = training_args.max_steps
    lr, warm = training_args.learning_rate, training_args.warmup_steps
    sched = {"linear": lambda: linear_lr(lr, warm, total),
             "cosine": lambda: cosine_lr(lr, warm, total),
             "const": lambda: const_lr(lr, warm),
             }[training_args.lr_scheduler_type]()
    grad_sync = None
    if n_dp * n_mp > 1:
        # every rank starts from rank 0's trainable tensors; their
        # gradients are averaged over all the ranks before each update (a
        # model group's ranks hold equal gradients)
        with torch.no_grad():
            for t in tensors:
                torch.distributed.broadcast(t.data, 0)
        grad_sync = lambda: allreduce_grads(tensors)  # noqa: E731
    # HF TrainingArguments default: weight decay 0 (run_train.sh sets none)
    state = Vlm2VecState(model=model, optimizer=adamw_over(tensors),
                         schedule=sched, params=trainable,
                         grad_sync=grad_sync)

    chunks = 0
    if training_args.grad_cache:
        # each rank chunks its own rows; the cached gradients are the
        # global loss's
        chunk_size = max(training_args.gc_q_chunk_size, 1)
        if local_bs % chunk_size:
            raise ValueError(f"batch size {local_bs} not divisible by "
                             f"gc_q_chunk_size {chunk_size}")
        chunks = local_bs // chunk_size
    common = dict(lora_alpha=float(model_args.lora_alpha),
                  temperature=model_args.temperature,
                  grad_cache_chunks=chunks)
    step = (make_vlm2vec_mixed_train_step(model, base=model_args.lora,
                                          **common)
            if mixed else make_vlm2vec_train_step(model, **common))

    out_dir = training_args.output_dir if main_rank else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    def save_trainable(tag: str):
        if not out_dir:
            return
        from ..core.convert import jax_params_from_module
        from ..core.factory import save_params_npz

        path = os.path.join(out_dir, f"adapter-{tag}.npz" if model_args.lora
                            else f"params-{tag}.npz")
        if model_args.lora:
            tree = {k: {n: t.detach().float().cpu().numpy()
                        for n, t in ab.items()} for k, ab in trainable.items()}
        else:
            tree = jax_params_from_module(model)
        save_params_npz(tree, path)
        log.info("saved %s", path)

    # -- loop -----------------------------------------------------------------
    log.info("training %d steps (bs %d%s%s)", total, bs,
             f", grad-cache chunks {chunks}" if chunks else "",
             ", mixed batches" if mixed else ", image-query pairs")
    report = {"losses": [], "samples_per_s": [], "peak_gib": None,
              "route": route}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i >= total:
            break
        if n_dp > 1:
            batch = pmesh.shard_batch(batch, rank, n_dp)
        metrics = step(state, to_device(batch, device, dtype))
        if (i + 1) % training_args.logging_steps == 0:
            loss = float(metrics["loss"])  # waits for the step
            rate = bs * (i + 1) / (time.perf_counter() - t0)
            report["losses"].append(loss)
            report["samples_per_s"].append(rate)
            log.info("step %d/%d loss %.4f (%.1f samples/s, %.1f "
                     "samples/s/chip)", i + 1, total, loss, rate,
                     rate / n_dp)
        if (i + 1) % training_args.save_steps == 0 and i + 1 < total:
            save_trainable(f"{i + 1:06d}")
    if device.type == "cuda":
        report["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        log.info("peak device memory %.2f GiB", report["peak_gib"])

    save_trainable("final")
    if out_dir and model_args.lora:
        if model_args.quant_base:
            # int8 weights cannot absorb fp deltas: serve adapter-final.npz
            # through the side-path (cli/eval_mmeb.py --quant_base)
            log.info("--quant_base: skipping merged-bundle export (int8 "
                     "base; serve adapter-final.npz unmaterialized)")
        else:
            merged = merge_lora(model, trainable,
                                alpha=float(model_args.lora_alpha))
            save_merged(os.path.join(out_dir, "merged"), cfg, merged)
            del merged
            log.info("saved merged score bundle -> %s",
                     os.path.join(out_dir, "merged"))
    return state, report


if __name__ == "__main__":
    main()
