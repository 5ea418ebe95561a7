"""CIDEr (Consensus-based Image Description Evaluation) scorer.

Self-contained implementation of the published CIDEr-D-free CIDEr algorithm
(Vedantam et al., CVPR 2015) as used by pycocoevalcap's ``CiderScorer`` with
``n=4, sigma=6.0`` — the configuration the reference pins
(``testbed/evaluate/metrics/CIDEr/CIDEr.py:147-155``).  Inputs are tokenized with the
pure-Python PTB tokenizer (``ptb_tokenizer.py``) instead of the reference's Java
subprocess.

Algorithm (must match pycocoevalcap numerics for parity):
- n-gram TF-IDF vectors per sentence, idf = log(#images) − log(max(1, df))
- df computed over the union of each image's reference n-grams
- per-n cosine similarity with *clipped* candidate counts
  (min(hyp, ref) · ref), scaled by a Gaussian length penalty
  exp(−(len_h − len_r)² / 2σ²) where lengths are **bigram counts**
  (a pycocoevalcap quirk kept for parity)
- averaged over n = 1..4 and over references, ×10
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, List, Tuple

from .base import Metric
from .ptb_tokenizer import tokenize_for_caption_metrics

NGramCounts = Dict[Tuple[str, ...], int]


def _precook(sentence: str, n: int = 4) -> NGramCounts:
    words = sentence.split()
    counts: NGramCounts = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


class CiderScorer:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma
        self.ctest: List[NGramCounts] = []
        self.crefs: List[List[NGramCounts]] = []

    def append(self, test: str, refs: List[str]) -> None:
        self.ctest.append(_precook(test, self.n))
        self.crefs.append([_precook(ref, self.n) for ref in refs])

    def _doc_frequency(self) -> Dict[Tuple[str, ...], float]:
        df: Dict[Tuple[str, ...], float] = defaultdict(float)
        for refs in self.crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                df[ngram] += 1
        return df

    def compute_score(self) -> Tuple[float, List[float]]:
        df = self._doc_frequency()
        ref_len = math.log(float(len(self.crefs)))

        def counts2vec(cnts: NGramCounts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ngram, term_freq in cnts.items():
                idf = ref_len - math.log(max(1.0, df[ngram]))
                k = len(ngram) - 1
                vec[k][ngram] = float(term_freq) * idf
                norm[k] += vec[k][ngram] ** 2
                if k == 1:  # pycocoevalcap counts length from bigrams
                    length += term_freq
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vec_h, vec_r, norm_h, norm_r, len_h, len_r) -> List[float]:
            delta = float(len_h - len_r)
            penalty = math.exp(-(delta**2) / (2 * self.sigma**2))
            vals = []
            for k in range(self.n):
                v = 0.0
                for ngram, count in vec_h[k].items():
                    v += min(count, vec_r[k][ngram]) * vec_r[k][ngram]
                if norm_h[k] != 0 and norm_r[k] != 0:
                    v /= norm_h[k] * norm_r[k]
                vals.append(v * penalty)
            return vals

        scores = []
        for test, refs in zip(self.ctest, self.crefs):
            vec, norm, length = counts2vec(test)
            acc = [0.0] * self.n
            for ref in refs:
                vec_r, norm_r, len_r = counts2vec(ref)
                for k, v in enumerate(sim(vec, vec_r, norm, norm_r, length, len_r)):
                    acc[k] += v
            score = sum(acc) / self.n / len(refs) * 10.0
            scores.append(score)
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores


class CIDEr(Metric):
    """Caption metric: PTB-tokenize predictions and references, then CIDEr score."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        super().__init__()
        self.n = n
        self.sigma = sigma

    def _compute(self, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        scorer = CiderScorer(n=self.n, sigma=self.sigma)
        for row in rows:
            pred = tokenize_for_caption_metrics(row["prediction"])
            refs = [tokenize_for_caption_metrics(r) for r in row["reference"]]
            scorer.append(pred, refs)
        score, _ = scorer.compute_score()
        return {"CIDEr": score}
