"""Autoregressive generation (counterpart of
``clip_embeds_tpu/models/generate.py``): greedy decoding through the Llama
trunk's KV cache (LLaVA's answers), HF's logits processors, and CoCa's
sampling and beam search.

Where JAX runs a ``lax.while_loop``, the port runs a Python loop with the
same state and the same stopping rule: a step runs while tokens are left
and some row is not done. Reading the ``done`` mask waits for the device,
so the loops read it only where a row can finish (an ``eos_token_id`` is
given).

Greedy decoding (:func:`greedy_generate`) prefills the cache with the
prompt (positions ``0..n-1``), then feeds each decoded token at the slot
and RoPE position ``n + step``. The JAX function gives the step position
``n + step + 1``: a decoded token one position past its cache slot, so
its tokens leave the argmax of the model's own full forward from the
second token on. The port does not copy that.
:func:`llava_greedy_generate` decodes through the model's own
``language_model``, its int8 projections and attached adapters included;
JAX's rebuilds an unquantised LM without the adapters (and raises on a
W8A8 tree). Its cache holds the prompt plus the new tokens, not
``max_position_embeddings`` (:func:`init_cache`'s default, as JAX's):
slots past the filled ones are masked and get exactly zero weight, so
the tokens are the same either way.

CoCa's generation recomputes the whole prefix each step over a fixed
buffer, as JAX and the reference do. Sampling draws from an explicit
``torch.Generator`` by the Gumbel-max rule, the law of
``jax.random.categorical``, not its draws; top-k 1 and beam search are
deterministic and give JAX's tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from .llama import KVCache


def init_cache(model, batch_size: int, max_len: Optional[int] = None
               ) -> KVCache:
    """A zero :class:`~.llama.KVCache` for a ``LlamaForCausalLM``-like
    ``model`` (``cfg``, ``embed_tokens``) in its dtype and on its device,
    ``max_len`` slots a layer (default: ``max_position_embeddings``, as
    JAX's)."""
    w = model.embed_tokens.weight
    return KVCache.empty(model.cfg, batch_size,
                         max_len or model.cfg.max_position_embeddings,
                         w.dtype, w.device)


@torch.no_grad()
def greedy_generate(model, input_ids: Optional[torch.Tensor],
                    max_new_tokens: int, eos_token_id: Optional[int] = None,
                    inputs_embeds: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Greedy decode -> int64 [B, max_new_tokens], padded with eos after a
    row stops. ``input_ids`` [B, L]: the prompt, unpadded (or None with
    ``inputs_embeds`` [B, L, D]). The cache holds L + max_new_tokens
    slots."""
    embeds = inputs_embeds if inputs_embeds is not None \
        else model.embed(input_ids)
    b, n = embeds.shape[:2]
    dev = embeds.device
    cache = init_cache(model, b, n + max_new_tokens)
    positions = torch.arange(n, device=dev).expand(b, n)
    hidden, cache = model.trunk(embeds, None, positions, cache=cache)
    token = model.logits(hidden[:, -1:])[:, 0].argmax(-1)
    out = torch.full((b, max_new_tokens),
                     0 if eos_token_id is None else eos_token_id,
                     dtype=torch.long, device=dev)
    out[:, 0] = token
    done = (token == eos_token_id) if eos_token_id is not None else None
    for step in range(max_new_tokens - 1):
        if done is not None and bool(done.all()):
            break
        pos = torch.full((b, 1), n + step, dtype=torch.long, device=dev)
        hidden, cache = model.trunk(model.embed(token[:, None]), None, pos,
                                    cache=cache)
        nxt = model.logits(hidden)[:, 0].argmax(-1)
        if done is not None:
            done = done | (token == eos_token_id)
            nxt = torch.where(done, eos_token_id, nxt)
        out[:, step + 1] = nxt
        token = nxt
    return out


@torch.no_grad()
def llava_greedy_generate(model, input_ids: torch.Tensor,
                          pixel_values: torch.Tensor, max_new_tokens: int,
                          eos_token_id: Optional[int] = None
                          ) -> torch.Tensor:
    """Greedy answers of a ``models/llava.py Llava`` (or a model with its
    ``encode_images`` / ``merge`` / ``language_model``): the image
    features spliced into the prompt at its one ``IMAGE_TOKEN_INDEX`` a
    row (``input_ids`` [B, L], unpadded; ``pixel_values`` [B, S, S, 3]),
    then :func:`greedy_generate` through ``model.language_model``."""
    embeds = model.merge(input_ids, model.encode_images(pixel_values))
    return greedy_generate(model.language_model, None, max_new_tokens,
                           eos_token_id, inputs_embeds=embeds)


# -- logits processors / warpers (HF GenerationMixin semantics) --------------


def min_length_process(logits: torch.Tensor, cur_len: int, min_len: int,
                       eos_token_id: int) -> torch.Tensor:
    """MinLengthLogitsProcessor: eos impossible before ``min_len``."""
    if cur_len >= min_len:
        return logits
    out = logits.clone()
    out[:, eos_token_id] = float("-inf")
    return out


def repetition_penalty_process(logits: torch.Tensor, tokens: torch.Tensor,
                               token_valid: torch.Tensor,
                               penalty: float) -> torch.Tensor:
    """RepetitionPenaltyLogitsProcessor: the scores of tokens present in
    ``tokens`` [B, L] where ``token_valid`` are divided (if > 0) or
    multiplied (if < 0) by ``penalty``."""
    if penalty == 1.0:
        return logits
    b, v = logits.shape
    valid = token_valid.expand(b, -1).long()
    presence = torch.zeros(b, v, dtype=torch.long, device=logits.device)
    presence = presence.scatter_reduce(1, tokens.clamp(0, v - 1), valid,
                                       reduce="amax").bool()
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def top_k_warp(logits: torch.Tensor, k: int) -> torch.Tensor:
    """TopKLogitsWarper: keep the k largest logits (and any tied with the
    k-th)."""
    kth = torch.topk(logits, k, dim=-1).values[:, -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_warp(logits: torch.Tensor, p: float,
               min_tokens_to_keep: int = 1) -> torch.Tensor:
    """TopPLogitsWarper: keep the smallest set of tokens whose cumulative
    probability exceeds p (HF's ascending-cumsum form; a stable sort, as
    ``jnp.argsort``, so ties order by index)."""
    sorted_idx = torch.argsort(logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, sorted_idx)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum <= (1.0 - p)
    remove[:, -min_tokens_to_keep:] = False
    masked = sorted_logits.masked_fill(remove, float("-inf"))
    return torch.empty_like(masked).scatter_(-1, sorted_idx, masked)


def sample_categorical(logits: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw a row from softmax(logits) by the Gumbel-max rule
    (``jax.random.categorical``'s law): argmax(logits + Gumbel noise), the
    uniforms from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return (logits + gumbel).argmax(-1)


# -- CoCa generation ----------------------------------------------------------


@torch.no_grad()
def coca_sample_generate(
    model, images: torch.Tensor,
    generator: Optional[torch.Generator] = None, seq_len: int = 30,
    temperature: float = 1.0, generation_type: str = "top_p",
    top_p: float = 0.1, top_k: int = 1, pad_token_id: int = 0,
    eos_token_id: int = 49407, sot_token_id: int = 49406,
    min_seq_len: int = 5, repetition_penalty: float = 1.0,
) -> torch.Tensor:
    """Top-k / top-p sampling with the min-length and repetition-penalty
    processors over a ``models/coca.py CoCa``: int64 [B, seq_len], SOT
    first, pad after eos, eos forced at the last slot of unfinished rows
    (the reference's coca_model.py:395-396)."""
    if generation_type not in ("top_p", "top_k"):
        raise ValueError(generation_type)
    b = images.shape[0]
    _, image_embs = model.image_tokens(images)
    dev = image_embs.device
    buf = torch.full((b, seq_len), pad_token_id, dtype=torch.long,
                     device=dev)
    buf[:, 0] = sot_token_id
    slots = torch.arange(seq_len, device=dev)[None, :]
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for step in range(seq_len - 1):
        if bool(done.all()):
            break
        cur = model.caption_logits(image_embs, buf)[:, step].float()
        cur_len = step + 1
        cur = min_length_process(cur, cur_len, min_seq_len, eos_token_id)
        cur = repetition_penalty_process(cur, buf, slots < cur_len,
                                         repetition_penalty)
        cur = (top_p_warp(cur, top_p) if generation_type == "top_p"
               else top_k_warp(cur, top_k))
        sample = sample_categorical(cur / temperature, generator)
        if cur_len == seq_len - 1:
            sample = torch.full_like(sample, eos_token_id)
        sample = torch.where(done, pad_token_id, sample)
        buf[:, cur_len] = sample
        done = done | (sample == eos_token_id)
    return buf


@torch.no_grad()
def coca_beam_generate(
    model, images: torch.Tensor, seq_len: int = 30, num_beams: int = 6,
    pad_token_id: int = 0, eos_token_id: int = 49407,
    sot_token_id: int = 49406, min_seq_len: int = 5,
    repetition_penalty: float = 1.0, length_penalty: float = 1.0,
) -> torch.Tensor:
    """Beam search as JAX runs it (the reference's _generate_beamsearch):
    finished beams freeze (their score stops changing and they emit pads),
    the candidates of all beams compete in one pool each step over beam x
    vocab, and the best beam by length-normalised score is returned:
    int64 [B, seq_len]. Ties in the pool order by index, as
    ``lax.top_k``'s."""
    b, nb = images.shape[0], num_beams
    _, image_embs = model.image_tokens(images)
    dev = image_embs.device
    image_embs = image_embs.repeat_interleave(nb, dim=0)  # [B*nb, Q, E]
    buf = torch.full((b, nb, seq_len), pad_token_id, dtype=torch.long,
                     device=dev)
    buf[:, :, 0] = sot_token_id
    # only beam 0 is live at step 0 (identical prefixes must not duplicate)
    scores = torch.full((b, nb), float("-inf"), device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros(b, nb, dtype=torch.bool, device=dev)
    lengths = torch.full((b, nb), seq_len, dtype=torch.long, device=dev)
    slots = torch.arange(seq_len, device=dev)[None, :]
    for step in range(seq_len - 1):
        if bool(done.all()):
            break
        flat_buf = buf.reshape(b * nb, seq_len)
        cur = model.caption_logits(image_embs, flat_buf)[:, step].float()
        vocab = cur.shape[-1]
        cur_len = step + 1
        cur = min_length_process(cur, cur_len, min_seq_len, eos_token_id)
        cur = repetition_penalty_process(cur, flat_buf, slots < cur_len,
                                         repetition_penalty)
        logp = torch.log_softmax(cur, dim=-1).reshape(b, nb, vocab)
        # a frozen beam offers one candidate: a pad that keeps its score
        cand = scores[:, :, None] + logp
        frozen = torch.full_like(cand, float("-inf"))
        frozen[:, :, pad_token_id] = scores
        cand = torch.where(done[:, :, None], frozen, cand)
        top_scores, top_idx = torch.sort(cand.reshape(b, nb * vocab),
                                         dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :nb], top_idx[:, :nb]
        beam_idx = top_idx // vocab
        token = top_idx % vocab
        buf = torch.gather(buf, 1, beam_idx[:, :, None].expand(-1, -1,
                                                               seq_len))
        new_done = torch.gather(done, 1, beam_idx)
        lengths = torch.gather(lengths, 1, beam_idx)
        token = torch.where(new_done, pad_token_id, token)
        buf[:, :, cur_len] = token
        finished_now = ~new_done & (token == eos_token_id)
        lengths = torch.where(finished_now, cur_len + 1, lengths)
        done = new_done | finished_now
        scores = top_scores
    norm = scores / lengths.float() ** length_penalty
    best = norm.argmax(dim=1)
    return buf[torch.arange(b, device=dev), best]
