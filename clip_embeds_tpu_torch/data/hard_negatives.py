"""Hard-negative captions by keyword or phrase swapping: the port's own
copy of ``clip_embeds_tpu/data/hard_negatives.py`` (the reference's
``DataMixDataset._modify`` with augfiles such as ``leftright.json``, which
maps spatial phrases to their opposites). Phrase mode replaces the first
matching phrase, word mode every matching word. The draws come from
``random.Random``, so a seed gives the JAX package's strings.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence

# The NegCLIP left/right augmentation shipped with the reference
# (open_clip/src/leftright.json:1-8).
LEFTRIGHT_SWAPS: Dict[str, List[str]] = {
    "on the left": ["on the right"],
    "on the right": ["on the left"],
    "to the left": ["to the right"],
    "to the right": ["to the left"],
    "at the left": ["at the right"],
    "at the right": ["at the left"],
}


class HardNegativeAugmenter:
    def __init__(
        self,
        keywords: Optional[Dict[str, List[str]]] = None,
        augfiles: Optional[Sequence[str]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.keywords: Dict[str, List[str]] = dict(keywords or {})
        for path in augfiles or ():
            with open(path) as fh:
                self.keywords.update(json.load(fh))
        self.phrases = any(" " in k for k in self.keywords)
        self.rng = rng or random.Random()

    def __call__(self, text: str) -> Optional[str]:
        """Swapped caption, or None when no keyword matches."""
        if self.phrases:
            for phrase, alternatives in self.keywords.items():
                if text.find(phrase) != -1:
                    return text.replace(phrase, self.rng.choice(alternatives))
            return None
        out, matched = [], False
        for word in text.split():
            if word.lower() in self.keywords:
                matched = True
                out.append(self.rng.choice(self.keywords[word.lower()]))
            else:
                out.append(word)
        return " ".join(out) if matched else None


def leftright_augmenter(seed: Optional[int] = None) -> HardNegativeAugmenter:
    rng = random.Random(seed) if seed is not None else None
    return HardNegativeAugmenter(LEFTRIGHT_SWAPS, rng=rng)
