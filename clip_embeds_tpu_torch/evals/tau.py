"""Pairwise-accuracy-with-ties Kendall tau optimization: the port's own
copy of ``clip_embeds_tpu/evals/tau.py`` (numpy only).

Reimplementation of the tie-calibration procedure used by the reference for
human-correlation evaluation (t2v_metrics/tau_optimization.py, a port of the
Apache-2.0 Google routine from arXiv:2305.14324): sweep a threshold epsilon
over metric-score differences, turning every pair with |m_i - m_j| <= eps
into a metric tie, and pick the eps maximizing the average per-row tau.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class TauStats:
    """Sufficient statistics for tau variants over (human, metric) pairs."""

    con: int = 0
    dis: int = 0
    ties_human: int = 0
    ties_metric: int = 0
    ties_both: int = 0

    @property
    def num_pairs(self) -> int:
        return (self.con + self.dis + self.ties_human + self.ties_metric
                + self.ties_both)

    def tau_23(self) -> float:
        return (self.con + self.ties_both - self.dis - self.ties_human
                - self.ties_metric) / self.num_pairs

    def acc_23(self) -> float:
        return (self.con + self.ties_both) / self.num_pairs

    def acc_ignore_tie(self) -> float:
        denom = self.num_pairs - self.ties_human
        return 1.0 if denom == 0 else self.con / denom

    def add(self, other: "TauStats", sign: int = 1) -> None:
        self.con += sign * other.con
        self.dis += sign * other.dis
        self.ties_human += sign * other.ties_human
        self.ties_metric += sign * other.ties_metric
        self.ties_both += sign * other.ties_both


@dataclasses.dataclass
class TauOptimizationResult:
    thresholds: List[float]
    taus: List[float]
    best_threshold: float
    best_tau: float


def _classify(h1, h2, m1, m2) -> TauStats:
    if h1 == h2 and m1 == m2:
        return TauStats(ties_both=1)
    if h1 == h2:
        return TauStats(ties_human=1)
    if m1 == m2:
        return TauStats(ties_metric=1)
    if (h1 > h2) == (m1 > m2):
        return TauStats(con=1)
    return TauStats(dis=1)


def tau_optimization(
    metric_scores,
    human_scores,
    tau_fn: Callable[[TauStats], float] = TauStats.acc_23,
    sample_rate: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> TauOptimizationResult:
    """Find the tie threshold maximizing the mean per-row tau.

    metric_scores/human_scores: N x M (or 1-D) arrays; None marks missing
    entries (use dtype=object rows). Rows are e.g. per-prompt candidate sets.
    """
    if not 0 < sample_rate <= 1:
        raise ValueError(f"sample_rate must be in (0, 1], got {sample_rate}")
    metric = np.asarray(metric_scores)
    human = np.asarray(human_scores)
    if metric.ndim == 1:
        metric = metric[None]
        human = human[None]
    if metric.shape != human.shape:
        raise ValueError("score matrices must have the same shape")
    rng = rng or np.random.default_rng()

    pairs = []  # (diff, row, stats, tie_stats)
    row_stats = {}
    for row in range(metric.shape[0]):
        valid = [
            (h, m) for h, m in zip(human[row], metric[row])
            if h is not None and m is not None
        ]
        for i in range(len(valid)):
            for j in range(i + 1, len(valid)):
                if sample_rate < 1.0 and rng.random() > sample_rate:
                    continue
                h1, m1 = valid[i]
                h2, m2 = valid[j]
                stats = _classify(h1, h2, m1, m2)
                tie_stats = (
                    TauStats(ties_both=1) if h1 == h2 else TauStats(ties_metric=1)
                )
                pairs.append((abs(m1 - m2), row, stats, tie_stats))
                row_stats.setdefault(row, TauStats()).add(stats)

    num_rows = len(row_stats)
    if num_rows == 0:
        # every pair was sampled away (or inputs held < 2 valid entries);
        # the reference port divides by zero here — return a NaN result
        return TauOptimizationResult(
            thresholds=[0.0], taus=[float("nan")],
            best_threshold=0.0, best_tau=float("nan"),
        )
    thresholds = [0.0]
    total = sum(tau_fn(s) for s in row_stats.values())
    taus = [total / num_rows]

    pairs.sort(key=lambda p: p[0])
    for diff, row, stats, tie_stats in pairs:
        total -= tau_fn(row_stats[row])
        row_stats[row].add(stats, -1)
        row_stats[row].add(tie_stats)
        total += tau_fn(row_stats[row])
        overall = total / num_rows
        if thresholds[-1] == diff:
            taus[-1] = overall
        else:
            thresholds.append(diff)
            taus.append(overall)

    best = int(np.nanargmax(taus))
    return TauOptimizationResult(
        thresholds=thresholds, taus=taus,
        best_threshold=thresholds[best], best_tau=taus[best],
    )


def kendall_variants(
    gold_scores,
    metric_scores,
    variant: str = "acc23",
    epsilon: float = 0.0,
) -> float:
    """Kendall tau variants with an epsilon tie threshold on metric scores
    (reference t2v_metrics/dataset.py:71-152 KendallVariants)."""
    if epsilon < 0:
        raise ValueError("epsilon must be non-negative")
    x = np.asarray(metric_scores, float)
    y = np.asarray(gold_scores, float)
    assert not np.any(np.isnan(x)) and not np.any(np.isnan(y))

    n = x.size
    xi, xj = np.triu_indices(n, k=1)
    dx = x[xi] - x[xj]
    dy = y[xi] - y[xj]
    xtie = np.abs(dx) <= epsilon
    ytie = dy == 0
    con = int(np.sum(~xtie & ~ytie & (np.sign(dx) == np.sign(dy))))
    dis = int(np.sum(~xtie & ~ytie & (np.sign(dx) != np.sign(dy))))
    tie_both = int(np.sum(xtie & ytie))
    xtie_only = int(np.sum(xtie & ~ytie))
    ytie_only = int(np.sum(ytie & ~xtie))
    tot = con + dis + xtie_only + ytie_only + tie_both

    if variant == "b":
        xt, yt = xtie_only + tie_both, ytie_only + tie_both
        if xt == tot or yt == tot:
            return float("nan")
        return (con - dis) / np.sqrt(tot - xt) / np.sqrt(tot - yt)
    if variant == "23":
        return (con + tie_both - dis - xtie_only - ytie_only) / tot
    if variant == "acc23":
        return (con + tie_both) / tot
    raise ValueError(f"unknown variant {variant!r}")


def pearson(gold_scores, metric_scores) -> float:
    x = np.asarray(metric_scores, float)
    y = np.asarray(gold_scores, float)
    return float(np.corrcoef(x, y)[0, 1])


def correlation_metrics(
    gold_scores, metric_scores, sample_rate: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> dict:
    """The GenAI-Bench human-correlation bundle (dataset.py:1396-1420):
    pearson, kendall-b, and pairwise accuracy with tie calibration."""
    opt = tau_optimization(
        metric_scores, gold_scores, TauStats.acc_23,
        sample_rate=sample_rate, rng=rng,
    )
    return {
        "pearson": pearson(gold_scores, metric_scores),
        "kendall_b": kendall_variants(gold_scores, metric_scores, "b"),
        "pairwise_acc": opt.best_tau,
        "pairwise_acc_threshold": opt.best_threshold,
    }
