"""Caption-generation metrics: BLEU-1..4, METEOR, ROUGE_L, CIDEr, SPICE.
A copy of ``multimodal_baby_tpu/evaluation/textgen_metrics.py``, kept so
that the port imports nothing of the JAX package.

Full capability parity with the reference's pycocoevalcap wrapper
(multimodal/textgen_eval.py:11-56) — all five metric families, pure
Python (the reference's METEOR/SPICE run in a Java subprocess; without a
JVM, both are reimplemented natively: see meteor.py, spice.py).
The returned dict uses the same keys so downstream logging is unchanged.

Algorithms follow the published COCO-caption definitions:
- BLEU: corpus-level, clipped n-gram precision, closest-reference brevity
  penalty;
- METEOR: Meteor 1.5 English scoring (exact+stem[+synonym] alignment,
  content/function word weighting, fragmentation penalty) — meteor.py;
- ROUGE_L: sentence-level LCS F-score (beta=1.2), max over references,
  mean over samples;
- CIDEr: tf-idf weighted n-gram (n=1..4) cosine similarity with length
  gaussian penalty (sigma=6), average over n, x10;
- SPICE: scene-graph tuple F1 with rule-based shallow parse — spice.py.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n])
                   for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def corpus_bleu(list_of_references: List[List[str]], hypotheses: List[str],
                max_n: int = 4) -> List[float]:
    """Returns [BLEU_1, ..., BLEU_n] (cumulative, uniform weights)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for refs, hyp in zip(list_of_references, hypotheses):
        h = hyp.split()
        rs = [r.split() for r in refs]
        hyp_len += len(h)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            hng = _ngrams(h, n)
            max_ref = Counter()
            for r in rs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            clipped[n - 1] += sum(min(c, max_ref[ng])
                                  for ng, c in hng.items())
            totals[n - 1] += max(0, len(h) - n + 1)

    bp = 1.0 if hyp_len > ref_len else (
        math.exp(1 - ref_len / hyp_len) if hyp_len > 0 else 0.0)
    bleus = []
    log_sum = 0.0
    for n in range(max_n):
        p = clipped[n] / totals[n] if totals[n] > 0 else 0.0
        # tiny epsilon smoothing like pycocoevalcap's ratio guard
        log_sum += math.log(p) if p > 0 else -9999.0
        bleus.append(bp * math.exp(log_sum / (n + 1)))
    return bleus


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(list_of_references: List[List[str]], hypotheses: List[str],
            beta: float = 1.2) -> float:
    scores = []
    for refs, hyp in zip(list_of_references, hypotheses):
        h = hyp.split()
        best = 0.0
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(r, h)
            if lcs == 0:
                continue
            prec = lcs / len(h) if h else 0.0
            rec = lcs / len(r) if r else 0.0
            if prec and rec:
                f = ((1 + beta ** 2) * prec * rec
                     / (rec + beta ** 2 * prec))
                best = max(best, f)
        scores.append(best)
    return sum(scores) / len(scores) if scores else 0.0


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------

def cider(list_of_references: List[List[str]], hypotheses: List[str],
          max_n: int = 4, sigma: float = 6.0) -> float:
    # document frequencies over reference sets
    doc_freq = [defaultdict(int) for _ in range(max_n)]
    for refs in list_of_references:
        for n in range(max_n):
            seen = set()
            for ref in refs:
                seen.update(_ngrams(ref.split(), n + 1).keys())
            for ng in seen:
                doc_freq[n][ng] += 1
    log_num_docs = math.log(max(1.0, float(len(list_of_references))))

    def tfidf_vec(tokens, n):
        counts = _ngrams(tokens, n + 1)
        vec = {}
        norm = 0.0
        length = max(1e-9, float(sum(counts.values())))
        for ng, c in counts.items():
            df = math.log(max(1.0, float(doc_freq[n][ng])))
            w = (c / length) * max(0.0, log_num_docs - df)
            vec[ng] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for refs, hyp in zip(list_of_references, hypotheses):
        h = hyp.split()
        score_n = []
        for n in range(max_n):
            hv, hnorm = tfidf_vec(h, n)
            s = 0.0
            for ref in refs:
                r = ref.split()
                rv, rnorm = tfidf_vec(r, n)
                dot = sum(min(hv[ng], rv.get(ng, 0.0)) * rv.get(ng, 0.0)
                          for ng in hv)
                if hnorm > 0 and rnorm > 0:
                    delta = len(h) - len(r)
                    s += (dot / (hnorm * rnorm)) * math.exp(
                        -delta ** 2 / (2 * sigma ** 2))
            score_n.append(s / len(refs) * 10.0)
        scores.append(sum(score_n) / max_n)
    return sum(scores) / len(scores) if scores else 0.0


# ---------------------------------------------------------------------------

def evaluate(list_of_references: List[List[str]], hypotheses: List[str]
             ) -> Dict[str, float]:
    """Same output contract as the reference's textgen_eval.evaluate
    (textgen_eval.py:36-55): all five metric families."""
    from multimodal_baby_tpu_torch.evaluation.meteor import meteor
    from multimodal_baby_tpu_torch.evaluation.spice import spice

    assert len(list_of_references) == len(hypotheses)
    bleus = corpus_bleu(list_of_references, hypotheses)
    out = {f"Bleu_{i + 1}": b for i, b in enumerate(bleus)}
    out["METEOR"] = meteor(list_of_references, hypotheses)
    out["ROUGE_L"] = rouge_l(list_of_references, hypotheses)
    out["CIDEr"] = cider(list_of_references, hypotheses)
    out["SPICE"] = spice(list_of_references, hypotheses)
    return out
