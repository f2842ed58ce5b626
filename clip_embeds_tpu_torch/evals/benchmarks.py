"""Benchmark dataset classes with ``evaluate_scores`` (t2v_metrics pattern):
the port's own copy of ``clip_embeds_tpu/evals/benchmarks.py`` (numpy and
the standard library only).

Reference: t2v_metrics/dataset.py — each dataset yields
{'images': [...], 'texts': [...]} samples for Score.batch_forward and owns an
``evaluate_scores(scores)`` that turns the [N, n_img, n_txt] tensor into its
published metric (Winoground text/image/group :205-230; SugarCREPE text acc
:231-253; EqBen/Flickr variants :255-277). Data lives under a local root dir
(the reference auto-downloads via gdown/HF — zero-egress here, so the root
must be pre-populated; ``exists()`` reports availability).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .metrics import winoground_accuracy, winoground_scores


class BenchmarkDataset:
    """List of {'images': [...], 'texts': [...]} samples."""

    def __init__(self, root_dir: str):
        self.root_dir = root_dir
        self.samples: List[Dict] = []
        if self.exists():
            self.samples = self._load()

    def exists(self) -> bool:
        return os.path.isdir(self.root_dir)

    def _load(self) -> List[Dict]:
        raise NotImplementedError

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]

    def evaluate_scores(self, scores: np.ndarray) -> Dict[str, float]:
        raise NotImplementedError


class Winoground(BenchmarkDataset):
    """2 images x 2 captions; text/image/group accuracy
    (t2v dataset.py:277-378). Expects root with examples.jsonl + images/."""

    def _load(self):
        path = os.path.join(self.root_dir, "examples.jsonl")
        samples = []
        with open(path) as fh:
            for line in fh:
                ex = json.loads(line)
                samples.append({
                    "images": [
                        os.path.join(self.root_dir, "images",
                                     ex["image_0"] + ".png"),
                        os.path.join(self.root_dir, "images",
                                     ex["image_1"] + ".png"),
                    ],
                    "texts": [ex["caption_0"], ex["caption_1"]],
                })
        return samples

    def evaluate_scores(self, scores: np.ndarray) -> Dict[str, float]:
        return winoground_accuracy(winoground_scores(np.asarray(scores)))


class SugarCREPE(BenchmarkDataset):
    """1 image x (positive, hard-negative) captions; text accuracy
    (dataset.py:1916-1980, get_sugarcrepe_acc :242-253). Root holds
    <split>.json files keyed by id with tested_labels [pos, neg]."""

    SPLITS = (
        "add_att", "add_obj", "replace_att", "replace_obj",
        "replace_rel", "swap_att", "swap_obj",
    )

    def __init__(self, root_dir: str, image_root: Optional[str] = None):
        self.image_root = image_root or os.path.join(root_dir, "images")
        super().__init__(root_dir)

    def _load(self):
        samples = []
        self.split_slices = {}
        start = 0
        for split in self.SPLITS:
            path = os.path.join(self.root_dir, f"{split}.json")
            if not os.path.exists(path):
                continue
            with open(path) as fh:
                data = json.load(fh)
            for ex in data.values():
                samples.append({
                    "images": [os.path.join(self.image_root, ex["filename"])],
                    "texts": [ex["caption"], ex["negative_caption"]],
                })
            self.split_slices[split] = (start, len(samples))
            start = len(samples)
        return samples

    def evaluate_scores(self, scores: np.ndarray) -> Dict[str, float]:
        scores = np.asarray(scores)  # [N, 1, 2]
        correct = scores[:, 0, 0] > scores[:, 0, 1]
        out = {"text": float(correct.mean())}
        for split, (lo, hi) in getattr(self, "split_slices", {}).items():
            if hi > lo:
                out[f"text/{split}"] = float(correct[lo:hi].mean())
        return out


class EqBenMini(BenchmarkDataset):
    """Winoground-format subset (dataset.py:699-757): ann.json rows with
    image0/image1/caption0/caption1."""

    def _load(self):
        path = os.path.join(self.root_dir, "ann.json")
        with open(path) as fh:
            data = json.load(fh)
        return [{
            "images": [
                os.path.join(self.root_dir, "images", ex["image0"]),
                os.path.join(self.root_dir, "images", ex["image1"]),
            ],
            "texts": [ex["caption0"], ex["caption1"]],
        } for ex in data]

    evaluate_scores = Winoground.evaluate_scores


BENCHMARKS = {
    "winoground": Winoground,
    "sugarcrepe": SugarCREPE,
    "eqben_mini": EqBenMini,
}


def get_benchmark(name: str, root_dir: str, download: bool = False,
                  **kw) -> BenchmarkDataset:
    """``download=True`` self-provisions a missing root via the gated
    download hooks (mirrors the reference's first-use gdown/unzip,
    t2v_metrics/dataset.py:283-291) — see ``download_benchmark``."""
    if download and not os.path.isdir(root_dir):
        download_benchmark(name, root_dir)
    return BENCHMARKS[name.lower()](root_dir, **kw)


def run_benchmark(score, dataset: BenchmarkDataset, batch_size: int = 16):
    """score: scores.score.Score; returns (scores_tensor, metrics)."""
    tensor = score.batch_forward(dataset.samples, batch_size=batch_size)
    return tensor, dataset.evaluate_scores(tensor)


class NaturalBenchRetrieval(BenchmarkDataset):
    """2x2 winoground-format retrieval pairs (t2v dataset.py:1784-1843):
    metadata.json rows with image_0/image_1/caption_0/caption_1."""

    def _load(self):
        path = os.path.join(self.root_dir, "metadata.json")
        with open(path) as fh:
            metadata = json.load(fh)
        image_dir = os.path.join(self.root_dir, "images")
        return [{
            "images": [
                os.path.join(image_dir, ex["image_0"]),
                os.path.join(image_dir, ex["image_1"]),
            ],
            "texts": [ex["caption_0"], ex["caption_1"]],
        } for ex in metadata]

    evaluate_scores = Winoground.evaluate_scores


class COCOCounterfactuals(BenchmarkDataset):
    """COCO-Counterfactuals winoground-format pairs (dataset.py:1850-1914)."""

    _load = NaturalBenchRetrieval._load
    evaluate_scores = Winoground.evaluate_scores


class SeeTrue(BenchmarkDataset):
    """Binary alignment pairs: each sample one image x one text with a 0/1
    label (t2v dataset.py SeeTrue); metric = per-source accuracy with a 0.5
    threshold on the (normalized) score."""

    def _load(self):
        path = os.path.join(self.root_dir, "seetrue.json")
        with open(path) as fh:
            rows = json.load(fh)
        self.labels = [int(r["label"]) for r in rows]
        self.sources = [r.get("source", "all") for r in rows]
        return [{
            "images": [os.path.join(self.root_dir, "images", r["image"])],
            "texts": [r["text"]],
        } for r in rows]

    def evaluate_scores(self, scores: np.ndarray) -> Dict[str, float]:
        scores = np.asarray(scores).reshape(len(self.samples))
        preds = (scores > 0.5).astype(int)
        labels = np.asarray(self.labels)
        out = {"accuracy": float((preds == labels).mean())}
        for source in sorted(set(self.sources)):
            idx = [i for i, s in enumerate(self.sources) if s == source]
            out[f"accuracy/{source}"] = float(
                (preds[idx] == labels[idx]).mean()
            )
        return out


BENCHMARKS.update({
    "naturalbench_retrieval": NaturalBenchRetrieval,
    "coco_counterfactuals": COCOCounterfactuals,
    "seetrue": SeeTrue,
})


class GenAIBench(BenchmarkDataset):
    """GenAI-Bench image alignment (t2v dataset.py:1263-1430): generated
    images with per-prompt human 1-5 alignment ratings; metric = human
    correlation bundle, optionally per skill tag.

    Root layout: metadata.json {image_idx: {image, prompt, human_alignment:
    [ratings]}}, optional genai_skills.json {tag: [prompt_idx,...]}."""

    def _load(self):
        with open(os.path.join(self.root_dir, "metadata.json")) as fh:
            self.metadata = json.load(fh)
        self.keys = sorted(self.metadata)
        return [{
            "images": [os.path.join(self.root_dir, "images",
                                    self.metadata[k]["image"])],
            "texts": [self.metadata[k]["prompt"]],
        } for k in self.keys]

    def evaluate_scores(self, scores: np.ndarray) -> Dict[str, float]:
        from .tau import correlation_metrics

        ours = np.asarray(scores).reshape(len(self.samples))
        human = [
            float(np.mean(self.metadata[k]["human_alignment"]))
            for k in self.keys
        ]
        return {"alignment": correlation_metrics(human, ours)}

    def evaluate_scores_per_skill(self, scores: np.ndarray) -> Dict[str, Dict]:
        from .tau import correlation_metrics

        ours = np.asarray(scores).reshape(len(self.samples))
        human = np.asarray([
            float(np.mean(self.metadata[k]["human_alignment"]))
            for k in self.keys
        ])
        with open(os.path.join(self.root_dir, "genai_skills.json")) as fh:
            tags = json.load(fh)
        prompt_of = {
            k: self.metadata[k].get("prompt_idx", i)
            for i, k in enumerate(self.keys)
        }
        out = {}
        for tag, prompt_idxs in tags.items():
            idx = [i for i, k in enumerate(self.keys)
                   if prompt_of[k] in prompt_idxs]
            if idx:
                out[tag] = {"alignment": correlation_metrics(
                    human[idx], ours[idx]
                )}
        return out


BENCHMARKS["genai_bench"] = GenAIBench


class Pickapic(BenchmarkDataset):
    """Pick-a-Pic v1 preference subset (t2v dataset.py:1159-1271): 100
    curated (image_0, image_1, caption) triples; metric = preference accuracy
    (label_0 == 1 means image_0 preferred)."""

    # the paper's curated subset (dataset.py:1184-1190)
    SELECTED_IDXS = [
        1, 9, 385, 14, 138, 5, 31, 33, 39, 352, 21, 417, 399, 17, 82, 412, 78,
        53, 54, 59, 60, 308, 76, 142, 98, 259, 317, 110, 113, 118, 112, 119,
        144, 148, 149, 153, 159, 162, 172, 111, 124, 196, 197, 220, 35, 141,
        252, 475, 368, 214, 150, 43, 221, 163, 228, 236, 57, 326, 257, 266,
        268, 62, 274, 277, 278, 281, 105, 285, 286, 301, 419, 91, 312, 316,
        318, 319, 334, 335, 339, 340, 347, 350, 367, 374, 375, 382, 376, 387,
        345, 405, 411, 478, 441, 444, 99, 384, 472, 479, 490, 493,
    ]

    def _load(self):
        with open(os.path.join(self.root_dir, "test_captions.json")) as fh:
            all_data = json.load(fh)
        self.rows = []
        for sel in self.SELECTED_IDXS:
            if sel >= len(all_data):
                continue
            self.rows.append(all_data[sel])
        return [{
            "images": [
                os.path.join(self.root_dir, r["image_0"]),
                os.path.join(self.root_dir, r["image_1"]),
            ],
            "texts": [r["caption"]],
        } for r in self.rows]

    def evaluate_scores(self, scores: np.ndarray):
        scores = np.asarray(scores)          # [N, 2, 1]
        correct = []
        for r, s in zip(self.rows, scores):
            label = "0" if r["label_0"] == 1 else "1"
            pred = "0" if s[0, 0] >= s[1, 0] else "1"
            correct.append(pred == label)
        return {"accuracy": float(np.mean(correct))}


class Flickr30KNeg(BenchmarkDataset):
    """Flickr30K left/right/up/down hard negatives (t2v dataset.py:1997-2049
    Flickr30K_P): (image, neg_image) x (caption, neg_caption); metric = text
    accuracy (both directions) + individual accuracy (half-credit per
    direction, get_flickr30kp_acc :255-275). Root: metadata.tsv with columns
    images/neg_images/captions/neg_captions."""

    def _load(self):
        import csv

        rows = []
        with open(os.path.join(self.root_dir, "metadata.tsv")) as fh:
            for row in csv.DictReader(fh, delimiter="\t"):
                rows.append(row)
        return [{
            "images": [
                os.path.join(self.root_dir, r["images"]),
                os.path.join(self.root_dir, r["neg_images"]),
            ],
            "texts": [r["captions"], r["neg_captions"]],
        } for r in rows]

    def evaluate_scores(self, scores: np.ndarray):
        s = winoground_scores(np.asarray(scores))
        text = [r["c0_i0"] > r["c1_i0"] and r["c1_i1"] > r["c0_i1"] for r in s]
        indiv = [
            0.5 * (r["c0_i0"] > r["c1_i0"]) + 0.5 * (r["c1_i1"] > r["c0_i1"])
            for r in s
        ]
        return {"text": float(np.mean(text)),
                "individual": float(np.mean(indiv))}


class TIFA160(BenchmarkDataset):
    """TIFA-160 with DSG human Likert ratings (t2v dataset.py:464-604):
    one generated image per (prompt, model); metric = human-correlation
    bundle over per-item human averages. Root: metadata.json
    {key: {text, image_path, human_avg}}."""

    def _load(self):
        with open(os.path.join(self.root_dir, "metadata.json")) as fh:
            self.metadata = json.load(fh)
        self.keys = sorted(self.metadata)
        return [{
            "images": [os.path.join(self.root_dir, "images",
                                    self.metadata[k]["image_path"])],
            "texts": [self.metadata[k]["text"]],
        } for k in self.keys]

    def evaluate_scores(self, scores: np.ndarray):
        from .tau import correlation_metrics

        ours = np.asarray(scores).reshape(len(self.samples))
        human = [float(self.metadata[k]["human_avg"]) for k in self.keys]
        keep = ~np.isnan(ours)
        return correlation_metrics(
            list(np.asarray(human)[keep]), list(ours[keep])
        )


class Flickr8KCF(BenchmarkDataset):
    """Flickr8K-CrowdFlower caption-quality judgements (t2v dataset.py:
    607-696): one sample per (image, candidate-caption) human judgement;
    metric = correlation bundle with pairwise tie-optimization sampled at 10%
    (:688). Root: crowdflower_flickr8k.json in the reference's layout."""

    def _load(self):
        with open(os.path.join(
            self.root_dir, "crowdflower_flickr8k.json"
        )) as fh:
            dataset = json.load(fh)
        self.human_scores: List[float] = []
        samples = []
        for v in dataset.values():
            for judgement in v["human_judgement"]:
                samples.append({
                    "images": [os.path.join(self.root_dir, v["image_path"])],
                    "texts": [
                        " ".join(judgement["caption"].split())
                        .strip(".").strip(" ")
                    ],
                })
                self.human_scores.append(float(judgement["rating"]))
        return samples

    def evaluate_scores(self, scores: np.ndarray):
        from .tau import correlation_metrics

        ours = np.asarray(scores).reshape(len(self.samples))
        keep = ~np.isnan(ours)
        human = np.asarray(self.human_scores)[keep]
        return correlation_metrics(
            list(human), list(ours[keep]), sample_rate=0.1
        )


class FrameAveragedCorrelation(BenchmarkDataset):
    """Shared shape for the video/3D alignment sets (T2VScore dataset.py:
    774-980, GenAIBench_Video :1441-1627, StanfordT23D :983-1157): each
    sample is F frames/views x 1 prompt; our score = mean over frames;
    metric = correlation bundle vs mean human alignment. Root:
    metadata.json [{frames: [...], prompt, human_alignment: [...]}]."""

    def _load(self):
        with open(os.path.join(self.root_dir, "metadata.json")) as fh:
            self.videos = json.load(fh)
        return [{
            "images": [os.path.join(self.root_dir, f) for f in v["frames"]],
            "texts": [str(v["prompt"])],
        } for v in self.videos]

    def evaluate_scores(self, scores: np.ndarray):
        from .tau import correlation_metrics

        scores = np.asarray(scores)          # [N, F, 1]
        ours = scores.mean(axis=1).reshape(len(self.videos))
        human = [float(np.mean(v["human_alignment"])) for v in self.videos]
        return {"alignment": correlation_metrics(human, list(ours))}


class T2VScore(FrameAveragedCorrelation):
    """EvalCrafter text-to-video alignment (dataset.py:774-980)."""


class GenAIBenchVideo(FrameAveragedCorrelation):
    """GenAI-Bench video alignment (dataset.py:1441-1627)."""


class StanfordT23D(FrameAveragedCorrelation):
    """Stanford text-to-3D alignment over rendered views (dataset.py:983-1157)."""


class GenAIBenchRanking(BenchmarkDataset):
    """GenAI-Bench image ranking: 9 images per prompt from one generator
    (dataset.py:1631-1781). Metrics: correlation bundle over all images plus
    per-prompt argmax-vs-argmin ranking accuracy. Root: human_rating.json
    (reference layout) + images under <gen_model>/."""

    def __init__(self, root_dir: str, gen_model: str = "DALLE_3"):
        self.gen_model = gen_model
        super().__init__(root_dir)

    def _load(self):
        with open(os.path.join(self.root_dir, "human_rating.json")) as fh:
            self.dataset = json.load(fh)
        self.rows = []
        for prompt_idx in self.dataset:
            for img_idx in range(1, 10):
                self.rows.append({
                    "prompt_idx": prompt_idx,
                    "prompt": self.dataset[prompt_idx]["prompt"],
                    "image": os.path.join(
                        self.root_dir, self.gen_model,
                        f"{int(prompt_idx):05d}_{img_idx:02d}.jpeg",
                    ),
                    "human_score": float(np.mean(
                        self.dataset[prompt_idx]["models"][self.gen_model][
                            str(img_idx)
                        ]
                    )),
                })
        return [{"images": [r["image"]], "texts": [r["prompt"]]}
                for r in self.rows]

    def evaluate_scores(self, scores: np.ndarray):
        from .tau import kendall_variants, pearson

        ours = np.asarray(scores).reshape(len(self.rows))
        human = np.asarray([r["human_score"] for r in self.rows])
        n_prompts = len(self.rows) // 9
        ours_p = ours.reshape(n_prompts, 9)
        human_p = human.reshape(n_prompts, 9)
        amax = human_p.argmax(axis=1)
        amin = human_p.argmin(axis=1)
        rows = np.arange(n_prompts)
        ranking_acc = float(
            (ours_p[rows, amax] > ours_p[rows, amin]).mean()
        )
        return {
            "pearson": pearson(list(human), list(ours)),
            "kendall_b": kendall_variants(list(human), list(ours), "b"),
            "ranking_accuracy": ranking_acc,
        }


BENCHMARKS.update({
    "pickapic_v1": Pickapic,
    "flickr30k_p": Flickr30KNeg,
    "tifa160_dsg": TIFA160,
    "flickr8k_cf": Flickr8KCF,
    "t2vscore": T2VScore,
    "genai_bench_video": GenAIBenchVideo,
    "stanford_t23d": StanfordT23D,
    "genai_bench_ranking": GenAIBenchRanking,
})


# -- gated auto-download hooks -------------------------------------------
#
# The reference self-provisions benchmark roots at first use via gdown/wget
# + unzip (t2v_metrics/dataset.py:283-291 Winoground, :392-400 SeeTRUE,
# :475-480 TIFA160, :619-624 Flickr8K-CF, :711-715 EqBen). This env has
# zero egress, so the hooks are OFF by default and hard-gated behind
# CLIP_EMBEDS_ALLOW_DOWNLOAD=1; the fetcher is injectable for tests (the
# same pattern as core/openclip_registry.download_pretrained).

_GDRIVE_URL = "https://drive.google.com/uc?export=download&id={}"

DOWNLOAD_SOURCES = {
    # name -> (archive url, archive filename); gdrive ids from the
    # reference's gdown calls (file:line cited above)
    "winoground": (_GDRIVE_URL.format("1Lril_90vjsbL_2qOaxMu3I-aPpckCDiF"),
                   "winoground.zip"),
    "tifa160_dsg": (_GDRIVE_URL.format("1hHVMeVDZlnJz1FFhy_BxiZGIz1tEMm0s"),
                    "tifa160.zip"),
    "flickr8k_cf": (_GDRIVE_URL.format("1WEg-xbUZ971P3Q0RDA8nVfKJrtpjTqCM"),
                    "flickr8k.zip"),
    "eqben_mini": (_GDRIVE_URL.format("11YUTf06uzRHtFV8rYi96z4vTPi8_GNEM"),
                   "eqben_vllm.zip"),
    "seetrue": ("https://huggingface.co/datasets/yonatanbitton/SeeTRUE/"
                "resolve/main/images.zip", "images.zip"),
}


def download_benchmark(name: str, root_dir: str, fetch=None) -> str:
    """Fetch + extract a benchmark's archive into ``root_dir``.

    Refuses unless ``CLIP_EMBEDS_ALLOW_DOWNLOAD=1`` (this build targets
    zero-egress deployments; the reference downloads unconditionally).
    ``fetch(url, dest_path)`` is injectable — tests pass a stub; production
    omits it for urllib. Returns root_dir."""
    import urllib.request
    import zipfile

    key = name.lower()
    if key not in DOWNLOAD_SOURCES:
        raise KeyError(
            f"no download source for {key!r} (have: "
            f"{sorted(DOWNLOAD_SOURCES)}); populate {root_dir} manually")
    if fetch is None:
        if os.environ.get("CLIP_EMBEDS_ALLOW_DOWNLOAD") != "1":
            raise RuntimeError(
                f"auto-download of {key!r} is disabled (zero-egress "
                "default); set CLIP_EMBEDS_ALLOW_DOWNLOAD=1 or pre-populate "
                f"{root_dir}")
        fetch = urllib.request.urlretrieve
    url, archive = DOWNLOAD_SOURCES[key]
    os.makedirs(root_dir, exist_ok=True)
    dest = os.path.join(root_dir, archive)
    if not os.path.exists(dest):
        fetch(url, dest)
    with zipfile.ZipFile(dest) as zf:
        zf.extractall(root_dir)
    return root_dir
