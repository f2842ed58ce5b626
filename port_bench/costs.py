"""Operations, bytes and model FLOPs of the benchmark's work, from the
published shapes alone (never from what a kernel happens to do).

``bound_ms``, ``attention_pairs`` and ``block_cost`` and the H100 peaks are
copies of the port's smoke script's arithmetic, kept here so that the
yardstick does not move with the program. Conventions:

* each input byte is read once and each output byte written once;
* causal attention counts only its kept (query, key) pairs, N(N+1)/2;
* padding counts as no work: head dim 88 is counted at 88 and 77 text
  rows at 77, whatever tile the kernel rounds them up to;
* model FLOPs are the matrix products of the forward pass (2 per
  multiply-add): patch embedding, the blocks' four projections, attention
  (QK^T and PV), the final projection. Training counts three forwards of a
  trained tower and one of a frozen tower; recomputation is not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12


def bound_ms(flops=0.0, int8_ops=0.0, nbytes=0.0):
    """The least time the card could take: the larger of the operations
    over their type's peak and the bytes over the memory rate; and which
    of the two bounds it."""
    t_ops = flops / PEAK_BF16 + int8_ops / PEAK_INT8
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_pairs(n, causal):
    """(query, key) pairs attention computes: N^2, or N(N+1)/2 causal."""
    return n * (n + 1) // 2 if causal else n * n


def block_cost(b, n, d, mlp, heads, kv, causal, extra_out=0, int8=False):
    """Operations and bytes of one block: the four projections over all n
    rows, attention over the kept (query, key) pairs; x, the weights and
    the biases read once, y (and ``extra_out`` more values per row)
    written once."""
    proj = 2 * b * n * (4 * d * d + 2 * d * mlp)
    pairs = (attention_pairs(kv, True) + (n - kv) * kv if causal
             else n * kv)
    attn = 4 * b * heads * pairs * (d // heads)
    vectors = 3 * d + d + mlp + d  # biases (and int8 scales), per output
    weights = 4 * d * d + 2 * d * mlp
    wbytes = (weights + vectors * 8 + 16 if int8  # int8, fp32 scale + bias
              else weights * 2 + vectors * 2)
    nbytes = 2 * b * n * d * 2 + wbytes + 4 * d * 2 + 2 * b * n * extra_out
    if int8:
        return bound_ms(flops=attn, int8_ops=proj, nbytes=nbytes)
    return bound_ms(flops=proj + attn, nbytes=nbytes)


def attention_fwd_cost(b, heads, n, hd, causal) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention forward over [b, heads, n, hd] in
    bf16: QK^T and PV over the kept pairs; q, k, v read and o written
    once."""
    flops = 4 * b * heads * attention_pairs(n, causal) * hd
    nbytes = 4 * b * heads * n * hd * 2
    return float(flops), float(nbytes)


def attention_bwd_cost(b, heads, n, hd, causal) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention backward in bf16, FlashAttention-2's
    count of 2.5 forwards: S = QK^T once more (the forward keeps only the
    log-sum-exp), dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q; q, k,
    v, o, dO read and dq, dk, dv written once, with the fp32 log-sum-exp
    read once."""
    flops = 10 * b * heads * attention_pairs(n, causal) * hd
    nbytes = 8 * b * heads * n * hd * 2 + 4 * b * heads * n
    return float(flops), float(nbytes)


def tower_rows(tower: Dict) -> int:
    """Rows a tower's blocks run over: 1 + patches, or the context."""
    if "image_size" in tower:
        return 1 + (tower["image_size"] // tower["patch_size"]) ** 2
    return tower["context_length"]


def tower_forward_flops(tower: Dict, embed_dim: int,
                        causal_pairs: bool = True) -> float:
    """Model FLOPs of one item through a tower (its ``configs/*.json``
    entry): patch embedding (image towers), the blocks, the pooled row's
    projection to ``embed_dim``. ``causal_pairs=False`` counts a causal
    tower's attention over all N^2 pairs, as a plain masked attention
    computes it."""
    w, mlp, layers = tower["width"], tower["mlp_width"], tower["layers"]
    n = tower_rows(tower)
    causal = bool(tower.get("causal", False))
    pairs = attention_pairs(n, causal and causal_pairs)
    block = 2 * n * (4 * w * w + 2 * w * mlp) + 4 * pairs * w
    flops = layers * block + 2 * w * embed_dim
    if "image_size" in tower:
        p = tower["patch_size"]
        flops += 2 * (n - 1) * 3 * p * p * w
    return float(flops)


def embed_flops_per_item(config: Dict, tower: str) -> float:
    """Model FLOPs of embedding one image ('vision') or one text ('text')."""
    return tower_forward_flops(config[tower], config["embed_dim"])


def train_flops_per_step(config: Dict, batch: int, hard_texts: int,
                         lock_image: bool) -> float:
    """Model FLOPs of one training step: the image tower over ``batch``
    images (three forwards, or one where it is locked), the text tower over
    ``batch`` + ``hard_texts`` texts (three forwards)."""
    img = tower_forward_flops(config["vision"], config["embed_dim"])
    txt = tower_forward_flops(config["text"], config["embed_dim"])
    return ((1 if lock_image else 3) * img * batch
            + 3 * txt * (batch + hard_texts))


def attention_shape(tower: Dict) -> Tuple[int, int, int, bool]:
    """(heads, rows, head dim, causal) of a tower's attention."""
    return (tower["heads"], tower_rows(tower),
            tower["width"] // tower["heads"], bool(tower.get("causal", False)))
