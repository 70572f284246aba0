"""METEOR scorer, pure Python (no JVM): a copy of
``multimodal_baby_tpu/evaluation/meteor.py`` with the port's own Porter
stemmer (``porter.py``, held equal to nltk's), kept so that the port
imports nothing of the JAX package and needs no nltk.

Reimplements the Meteor 1.5 scoring algorithm (Denkowski & Lavie 2014) that
the reference reaches through pycocoevalcap's Java subprocess
(the reference's multimodal/textgen_eval.py:2,40).  Stages:

  1. exact    — surface-form identity                        (weight 1.0)
  2. stem     — Porter-stemmed identity                      (weight 0.6)
  3. synonym  — WordNet synset overlap, only if nltk wordnet
                data is installed locally                    (weight 0.8)

  4. paraphrase — phrase-table span matches                  (weight 0.6)

The paraphrase stage is table-driven exactly like the Java scorer's: it
activates only when a paraphrase table is loaded (``load_paraphrase_table``
or the ``MMB_METEOR_PARAPHRASE`` env var pointing at a file of
``phrase ||| phrase`` or tab-separated lines — the format of Meteor's
``paraphrase-en`` data file, which is not shipped with the package and must be
supplied by the user).  Without a table the alignment is identical to the
three-stage scorer; with child-directed SAYCam utterances and COCO captions
the exact+stem stages dominate alignments either way.

Scoring follows the Meteor 1.5 English task parameters:
  alpha=0.85 (P/R harmonic weight), beta=0.2 (frag exponent),
  gamma=0.6 (penalty weight), delta=0.75 (content vs function word weight)

  P     = weighted matched hyp words / weighted hyp length
  R     = weighted matched ref words / weighted ref length
  Fmean = P*R / (alpha*P + (1-alpha)*R)
  Pen   = gamma * (chunks / avg_matches) ** beta
  score = Fmean * (1 - Pen)

where word weights are delta for content words and (1-delta) for function
words, and module weights scale each matched pair.  The alignment is a
beam search over per-hypothesis-word candidates that maximizes weighted
match total, then minimizes the number of chunks (contiguous runs matched
monotonically in both sentences) — the same objective Meteor's Aligner
optimizes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from multimodal_baby_tpu_torch.evaluation.porter import stem as _stem

ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75

STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, synonym, paraphrase

# Meteor ships a function-word list built from common-word frequency; this
# is the standard English closed-class inventory (articles, pronouns,
# prepositions, conjunctions, auxiliaries, particles).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both few many
most other such what which who whom whose i you he she it we they me him
her us them my your his its our their mine yours hers ours theirs myself
yourself himself herself itself ourselves yourselves themselves
and or but nor so yet for because although though while if unless until
when whenever where wherever after before since as than whether
in on at by with from to of about above across against along among around
behind below beneath beside between beyond down during except inside into
near off onto out outside over past through toward towards under
underneath up upon within without
am is are was were be been being do does did doing have has had having
will would shall should may might must can could
not n't 's 'm 're 've 'll 'd there here then now just only also very too
""".split())

try:  # synonym stage only when wordnet data is locally installed
    from nltk.corpus import wordnet as _wn
    _wn.synsets("dog")
    _HAVE_WORDNET = True
except Exception:  # pragma: no cover - no wordnet data installed
    _wn = None
    _HAVE_WORDNET = False


def _synsets(word: str) -> frozenset:
    if not _HAVE_WORDNET:
        return frozenset()
    return frozenset(s.name() for s in _wn.synsets(word))


class ParaphraseTable:
    """Symmetric phrase-equivalence table for the paraphrase stage.

    Meteor's Java aligner looks phrases up in ``data/paraphrase-en.gz``
    (one ``phrase1 ||| phrase2`` pair per line; plain-text tables use a
    tab).  Lookup is by word tuple; ``max_len`` bounds the span search.
    """

    def __init__(self, pairs: Sequence[Tuple[Sequence[str], Sequence[str]]]):
        table: Dict[Tuple[str, ...], set] = {}
        self.max_len = 1
        for a, b in pairs:
            ta, tb = tuple(a), tuple(b)
            if not ta or not tb or ta == tb:
                continue
            table.setdefault(ta, set()).add(tb)
            table.setdefault(tb, set()).add(ta)
            self.max_len = max(self.max_len, len(ta), len(tb))
        self._table = table

    @classmethod
    def from_file(cls, path: str) -> "ParaphraseTable":
        import gzip
        opener = gzip.open if path.endswith(".gz") else open
        pairs = []
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip().lower()
                if not line or line.startswith("#"):
                    continue
                if " ||| " in line:
                    parts = line.split(" ||| ")
                else:
                    parts = line.split("\t")
                if len(parts) >= 2:
                    pairs.append((parts[0].split(), parts[1].split()))
        return cls(pairs)

    def equivalents(self, phrase: Tuple[str, ...]) -> frozenset:
        return self._table.get(phrase, frozenset())

    def __len__(self) -> int:
        return len(self._table)


_PARAPHRASES: Optional[ParaphraseTable] = None
_PARA_ENV_CHECKED = False


def load_paraphrase_table(table: Optional[ParaphraseTable]) -> None:
    """Install (or clear, with None) the paraphrase stage's table."""
    global _PARAPHRASES, _PARA_ENV_CHECKED
    _PARAPHRASES = table
    _PARA_ENV_CHECKED = True


def _paraphrases() -> Optional[ParaphraseTable]:
    global _PARAPHRASES, _PARA_ENV_CHECKED
    if not _PARA_ENV_CHECKED:
        _PARA_ENV_CHECKED = True
        import os
        path = os.environ.get("MMB_METEOR_PARAPHRASE")
        if path:
            _PARAPHRASES = ParaphraseTable.from_file(path)
    return _PARAPHRASES


def _match_stage(h: str, r: str, h_stem: str, r_stem: str,
                 h_syn: frozenset, r_syn: frozenset) -> int:
    """Lowest stage index on which h and r match, or -1."""
    if h == r:
        return 0
    if h_stem == r_stem:
        return 1
    if h_syn and (h_syn & r_syn):
        return 2
    return -1


# A match is a span pair: (hyp_start, hyp_len, ref_start, ref_len, stage).
# Word-stage matches have len 1/1; the paraphrase stage may match
# multi-word spans, exactly as Meteor's Java Aligner does.
Match = Tuple[int, int, int, int, int]


def _count_chunks(matches: Sequence[Tuple[int, int, int, int]]) -> int:
    """Chunks = maximal runs of matches contiguous and monotone in both
    sentences (a multi-word span extends its chunk by its length)."""
    if not matches:
        return 0
    ordered = sorted(matches)
    chunks = 1
    for (h0, lh0, r0, lr0), (h1, _, r1, _) in zip(ordered, ordered[1:]):
        if h1 != h0 + lh0 or r1 != r0 + lr0:
            chunks += 1
    return chunks


def _span_candidates(hyp: List[str], ref: List[str]) -> List[List[Match]]:
    """Per-hyp-position match candidates across all active stages."""
    h_stems = [_stem(w) for w in hyp]
    r_stems = [_stem(w) for w in ref]
    h_syns = [_synsets(w) for w in hyp] if _HAVE_WORDNET else [frozenset()] * len(hyp)
    r_syns = [_synsets(w) for w in ref] if _HAVE_WORDNET else [frozenset()] * len(ref)

    candidates: List[List[Match]] = [[] for _ in hyp]
    for i, hw in enumerate(hyp):
        for j, rw in enumerate(ref):
            st = _match_stage(hw, rw, h_stems[i], r_stems[j],
                              h_syns[i], r_syns[j])
            if st >= 0:
                candidates[i].append((i, 1, j, 1, st))

    table = _paraphrases()
    if table is not None:
        # ref-phrase occurrence index up to the table's max span length
        ref_spans: Dict[Tuple[str, ...], List[Tuple[int, int]]] = {}
        for j in range(len(ref)):
            for lj in range(1, min(table.max_len, len(ref) - j) + 1):
                ref_spans.setdefault(tuple(ref[j:j + lj]), []).append((j, lj))
        for i in range(len(hyp)):
            for li in range(1, min(table.max_len, len(hyp) - i) + 1):
                for tgt in table.equivalents(tuple(hyp[i:i + li])):
                    for j, lj in ref_spans.get(tgt, ()):
                        candidates[i].append((i, li, j, lj, 3))
    return candidates


def _align(hyp: List[str], ref: List[str], beam: int = 40) -> List[Match]:
    """Return matched (hyp_start, hyp_len, ref_start, ref_len, stage) spans.

    Beam search over hypothesis positions: each step either leaves the
    word unmatched (advance 1) or applies a candidate match whose ref
    span is free (advance by the hyp span length).  States are ranked by
    (weighted match total, -chunks-so-far), mirroring Meteor's
    max-matches / min-chunks objective.
    """
    candidates = _span_candidates(hyp, ref)

    # beam per hyp position: position -> [(score, matches)]
    State = Tuple[float, List[Match]]
    at: Dict[int, Dict[frozenset, State]] = {0: {frozenset(): (0.0, [])}}
    for i in range(len(hyp)):
        here = at.pop(i, None)
        if not here:
            continue
        states = sorted(here.values(), key=lambda s: -s[0])[:beam]

        def consider(pos: int, score: float, matches: List[Match]):
            key = frozenset(
                r for _, _, j, lj, _ in matches for r in range(j, j + lj))
            slot = at.setdefault(pos, {})
            cur = slot.get(key)
            if cur is None or score > cur[0]:
                slot[key] = (score, matches)

        for score, matches in states:
            consider(i + 1, score, matches)  # leave word i unmatched
            used = {r for _, _, j, lj, _ in matches
                    for r in range(j, j + lj)}
            for m in candidates[i]:
                _, li, j, lj, st = m
                if any(r in used for r in range(j, j + lj)):
                    continue
                new_matches = matches + [m]
                w = STAGE_WEIGHTS[st] * max(li, lj)
                # chunk economy as a small tie-break inside the score
                ch = _count_chunks([t[:4] for t in new_matches])
                consider(i + li, score + w - 1e-4 * ch + 1e-4, new_matches)

    final = [s for slot in at.values() for s in slot.values()]

    # final selection: most matched words, then max weighted, then min
    # chunks — Meteor resolves ties the same way.
    def rank(state: State):
        _, matches = state
        words = sum(li + lj for _, li, _, lj, _ in matches) / 2.0
        wsum = sum(STAGE_WEIGHTS[st] * max(li, lj)
                   for _, li, _, lj, st in matches)
        ch = _count_chunks([t[:4] for t in matches])
        return (words, wsum, -ch)

    return max(final, key=rank)[1] if final else []


def _word_weight(word: str) -> float:
    return (1.0 - DELTA) if word in FUNCTION_WORDS else DELTA


class _Stats:
    """Meteor sufficient statistics for one (hyp, ref) alignment."""

    __slots__ = ("m_h", "m_r", "len_h", "len_r", "chunks", "matches")

    def __init__(self, m_h=0.0, m_r=0.0, len_h=0.0, len_r=0.0,
                 chunks=0, matches=0):
        self.m_h, self.m_r = m_h, m_r
        self.len_h, self.len_r = len_h, len_r
        self.chunks, self.matches = chunks, matches

    def score(self) -> float:
        p = self.m_h / self.len_h if self.len_h else 0.0
        r = self.m_r / self.len_r if self.len_r else 0.0
        if p + r == 0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        frag = self.chunks / self.matches if self.matches else 0.0
        return fmean * (1.0 - GAMMA * frag ** BETA)

    def add(self, other: "_Stats") -> None:
        self.m_h += other.m_h
        self.m_r += other.m_r
        self.len_h += other.len_h
        self.len_r += other.len_r
        self.chunks += other.chunks
        self.matches += other.matches


def _sentence_stats(references: Sequence[str],
                    hypothesis: str) -> Optional[_Stats]:
    """Stats against the best-scoring reference (Meteor picks the ref
    maximizing the sentence score, then contributes its stats)."""
    hyp = hypothesis.lower().split()
    if not hyp:
        return None
    best: Optional[_Stats] = None
    for reference in references:
        ref = reference.lower().split()
        if not ref:
            continue
        matches = _align(hyp, ref)
        st = _Stats(
            m_h=sum(STAGE_WEIGHTS[s] * _word_weight(hyp[w])
                    for i, li, _, _, s in matches
                    for w in range(i, i + li)),
            m_r=sum(STAGE_WEIGHTS[s] * _word_weight(ref[w])
                    for _, _, j, lj, s in matches
                    for w in range(j, j + lj)),
            len_h=sum(_word_weight(w) for w in hyp),
            len_r=sum(_word_weight(w) for w in ref),
            chunks=_count_chunks([m[:4] for m in matches]),
            matches=sum(li + lj for _, li, _, lj, _ in matches) / 2.0)
        if best is None or st.score() > best.score():
            best = st
    return best


def sentence_meteor(references: Sequence[str], hypothesis: str) -> float:
    """Meteor 1.5 sentence score: best reference."""
    stats = _sentence_stats(references, hypothesis)
    return stats.score() if stats is not None else 0.0


def meteor(list_of_references: List[List[str]],
           hypotheses: List[str]) -> float:
    """Corpus METEOR: aggregate sufficient statistics over the test set,
    then score the aggregate — the Java scorer's micro-average, which is
    what pycocoevalcap reports as the corpus number."""
    total = _Stats()
    for refs, hyp in zip(list_of_references, hypotheses):
        st = _sentence_stats(refs, hyp)
        if st is not None:
            total.add(st)
    return total.score()
