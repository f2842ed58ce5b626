"""PACL/SPARC training data: image-caption pairs with noun-phrase prompts
(the port's copy of ``clip_embeds_tpu/data/pacl_data.py``).

Reference: Patch-Aligned-Contrastive-Learning/data/image_caption_data.py —
COCO captions / LCS-558K / DataMix-665K and their concatenation; per sample a
random prompt template over a spacy noun chunk 50% of the time, the full
caption otherwise (:36-42 templates, :66-80 sampling); ImageNet-stats squash
transform; optional precomputed LLM text embeddings indexed in parallel
(:127-131 embed_path).

spacy is not installed where the port runs, so noun phrases come from a
regex-based chunker (determiner/adjective* noun+) over the offline POS
bucketizer; the spacy hook is used where it imports.
"""

from __future__ import annotations

import json
import os
import random
import re
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..image.preprocess import preprocess_pacl
from ..text.tokenizer import (
    BPETokenizer,
    get_tokenizer,
    simple_pos_tagger,
)

PROMPT_TEMPLATES = (
    "a picture of {}.",
    "itap of {}.",
    "a photograph of {}.",
    "this picture contains {}.",
    "a good photo of {}.",
)

# Rule-based base-NP chunker approximating spacy noun_chunks without the
# dependency (reference data/image_caption_data.py uses en_core_web_sm).
# Grammar per chunk: [det/poss/num]? [adjective]* [noun]+ — built over the
# lexicon POS bucketizer (text/tokenizer.py simple_pos_tagger).
_DETS = {
    "the", "a", "an", "his", "her", "its", "their", "my", "your", "our",
    "some", "any", "no", "each", "every", "this", "that", "these", "those",
    "one", "two", "three", "four", "five", "six", "many", "several", "few",
    "both", "all",
}
# verbs/adverbs/preps the lexicon tagger may miss in caption text
_NON_NOUN = {
    "riding", "sitting", "standing", "holding", "wearing", "eating",
    "playing", "walking", "running", "flying", "looking", "grazing",
    "swinging", "rising", "traveling", "preparing", "docked", "stopped",
    "arranged", "parked", "filled", "covered", "next", "top", "front",
    "close", "very", "around", "across", "while", "above", "below",
    "beside", "behind", "toward", "towards",
}


def _spacy_chunker() -> Optional[Callable[[str], List[str]]]:
    try:  # pragma: no cover - spacy is not installed
        import spacy

        nlp = spacy.load("en_core_web_sm")
    except (ImportError, OSError):  # no spacy, or no English pipeline
        return None
    return lambda text: [c.text.lower() for c in nlp(text).noun_chunks]


def regex_noun_phrases(caption: str) -> List[str]:
    """Base noun phrases of a caption (spacy noun_chunks approximation)."""
    words = re.findall(r"[a-z]+", caption.lower())
    tags = dict(zip(range(len(words)), simple_pos_tagger(words)))

    def is_noun(i: int) -> bool:
        w = words[i]
        return (tags[i][1] == "NN" and w not in _DETS
                and w not in _NON_NOUN and len(w) > 1)

    def is_adj(i: int) -> bool:
        w = words[i]
        return ((tags[i][1] == "JJ" or w in ("tall", "large", "small", "big",
                                             "old", "new", "red", "blue",
                                             "green", "yellow", "white",
                                             "black", "fresh", "busy",
                                             "little", "wooden", "crowded",
                                             "distant"))
                and w not in _NON_NOUN)

    out: List[str] = []
    i = 0
    n = len(words)
    while i < n:
        start = i
        if words[i] in _DETS:
            i += 1
        run_start = i
        while i < n and (is_noun(i) or is_adj(i)):
            i += 1
        # head = last word of the modifier/noun run (a trailing adjective is
        # promoted to head — caption nouns like 'table' carry -able/-y
        # suffixes the lexicon tagger reads as adjectives)
        if i > run_start and words[i - 1] not in _NON_NOUN \
                and len(words[i - 1]) > 2:
            out.append(" ".join(words[start:i]))
        elif i == start:
            i += 1  # nothing matched here; advance
    return out


class CaptionPromptSampler:
    """Template-over-noun-phrase prompt sampling (image_caption_data.py:66-80)."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.chunker = _spacy_chunker() or regex_noun_phrases

    def __call__(self, caption: str) -> str:
        phrases = self.chunker(caption)
        use_phrase = self.rng.choice([0, 1]) == 0
        if phrases and use_phrase:
            template = self.rng.choice(PROMPT_TEMPLATES)
            return template.format(self.rng.choice(phrases))
        return caption


class PACLCaptionDataset:
    """LLaVA-format annotations -> (image, prompt[, llm_embedding]) samples.

    Covers LCS558KDataset/DataMixDataset/CombinedDataset semantics: filter
    image-less samples, caption = random answer turn (first for pretraining),
    optional precomputed text-embedding .npy aligned by index.
    """

    def __init__(
        self,
        annotation_files: Sequence[str],
        image_roots: Sequence[str],
        image_size: int = 336,
        embed_paths: Optional[Sequence[str]] = None,
        pretraining: Sequence[bool] = (),
        seed: int = 0,
    ):
        assert len(annotation_files) == len(image_roots)
        self.samples: List[Tuple[dict, str, Optional[int], int]] = []
        self.embeds: List[Optional[np.ndarray]] = []
        for file_idx, (ann, root) in enumerate(zip(annotation_files, image_roots)):
            embed = None
            if embed_paths and embed_paths[file_idx]:
                embed = np.load(embed_paths[file_idx], mmap_mode="r")
            self.embeds.append(embed)
            with open(ann) as fh:
                data = json.load(fh)
            for row_idx, sample in enumerate(data):
                if "image" in sample:
                    self.samples.append((sample, root, file_idx, row_idx))
        self.image_size = image_size
        self.pretraining = list(pretraining)
        self.prompt_sampler = CaptionPromptSampler(seed)
        self.rng = random.Random(seed + 1)

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, idx: int):
        sample, root, file_idx, row_idx = self.samples[idx]
        pixels = preprocess_pacl(
            os.path.join(root, sample["image"]), self.image_size
        )
        turns = sample["conversations"]
        is_pretrain = (
            self.pretraining[file_idx] if file_idx < len(self.pretraining)
            else True
        )
        turn = 0 if is_pretrain else self.rng.randint(
            0, len(turns) // 2 - 1
        )
        caption = turns[turn * 2 + 1]["value"]
        prompt = self.prompt_sampler(caption)
        embed = self.embeds[file_idx]
        llm_embedding = (
            np.asarray(embed[row_idx], np.float32) if embed is not None else None
        )
        return pixels, prompt, llm_embedding


def pacl_batches(
    dataset: PACLCaptionDataset,
    batch_size: int,
    tokenizer: Optional[BPETokenizer] = None,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    num_workers: int = 8,
) -> Iterator[Dict[str, np.ndarray]]:
    from concurrent.futures import ThreadPoolExecutor

    tokenizer = tokenizer or get_tokenizer()
    order = np.arange(len(dataset))
    if shuffle:
        # per-epoch reshuffle (torch DataLoader(shuffle=True) semantics)
        np.random.default_rng((seed, epoch)).shuffle(order)
    with ThreadPoolExecutor(num_workers) as pool:
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = list(pool.map(dataset.get, order[start : start + batch_size]))
            batch = {
                "images": np.stack([it[0] for it in items]),
                "texts": tokenizer([it[1] for it in items]),
            }
            if items[0][2] is not None:
                batch["text_embeddings"] = np.stack([it[2] for it in items])
            yield batch
