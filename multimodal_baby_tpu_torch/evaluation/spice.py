"""SPICE scorer, pure Python (no JVM): a copy of
``multimodal_baby_tpu/evaluation/spice.py``, kept so that the port
imports nothing of the JAX package.

Reimplements the SPICE metric (Anderson et al. 2016) that the reference
reaches through pycocoevalcap's Java subprocess
(the reference's multimodal/textgen_eval.py:5,41): captions are parsed
into scene-graph tuples — objects, (object, attribute) pairs and
(subject, relation, object) triples — and the score is the F1 between the
candidate tuple set and the union of the reference tuple sets, averaged
over the corpus.

The Java pipeline uses the Stanford dependency parser; without a
JVM and parser models, so parsing is a rule-based shallow parse driven
by a closed-class lexicon + suffix heuristics (open class defaults to
NOUN).  Child-directed SAYCam utterances and COCO captions are short,
determiner-rich declaratives ("look at the ball", "a dog on the grass"),
where this grammar recovers the same propositions a full parse would:

  objects:    the head noun of each noun phrase (compound modifiers
              become attributes: "tennis court" -> (court,) + (court,
              tennis))
  attributes: ADJ modifying a noun (pre-nominal or copular) and
              object-less verbs ((girl, stand) for "a girl standing")
  relations:  (subject, verb, object) for adjacent direct objects,
              (left-head, preposition, right-head) for prepositions

Fidelity is measured, not asserted: a 61-caption fixture with
hand-derived expected tuples (tests/test_spice_fixture.py) passes
exactly, and the divergence envelope vs the Java pipeline is documented
there and in TEXTGEN_FIDELITY.md. Complex prepositions are collapsed to
one relation token exactly as Stanford's collapsed-dependencies stage
does ("on top of" -> on_top_of; MULTIWORD_PREPOSITIONS). Tuple matching is lemma-exact,
extended with WordNet synonym sets when the nltk wordnet data is
installed locally (the Java SPICE does the same synset matching).
"""

from __future__ import annotations

from typing import FrozenSet, List, Sequence, Set, Tuple

DETERMINERS = frozenset(
    "a an the this that these those some any no every each all both "
    "most much more other another such my your his her its our their "
    "what which whose".split())
PRONOUNS = frozenset(
    "i you he she it we they me him us them himself herself itself "
    "someone something anything nothing everyone everything who whom".split())
PREPOSITIONS = frozenset(
    "in on at by with of from to into onto under over above below behind "
    "beside between near around through across against along among inside "
    "outside within without upon beneath toward towards past off out up "
    "down".split())
CONJUNCTIONS = frozenset("and or but nor so yet because although while "
                         "if when where than whether".split())
COPULAS = frozenset("is are was were am be been being 's 're 'm".split())
AUXILIARIES = frozenset(
    "do does did will would shall should may might must can could have "
    "has had having not n't".split())
ADVERBS = frozenset("very really quite too also just only now then here "
                    "there always never often sometimes".split())
INTERJECTIONS = frozenset("oh wow hey yeah yes uh um hmm ooh aw look see "
                          "okay ok please thank thanks bye hi hello".split())
# High-frequency verbs that no suffix rule would catch.
COMMON_VERBS = frozenset(
    "go goes went going get gets got getting put puts putting take takes "
    "took taking make makes made making give gives gave giving want wants "
    "wanted like likes liked love loves loved eat eats ate eating play "
    "plays played playing hold holds held holding throw throws threw "
    "sit sits sat sitting stand stands stood run runs ran running come "
    "comes came coming say says said think thinks thought know knows knew "
    "find finds found read reads wear wears wore ride rides rode chase "
    "chases chased carry carries carried pull pulls push pushes drink "
    "drinks drank jump jumps jumped walk walks walked fly flies flew "
    "swim swims swam catch catches caught kick kicks kicked touch touches "
    "touched open opens opened close closes closed turn turns turned "
    "point points pointed show shows showed watch watches watched "
    "fall falls fell falling do does did doing done see sees seen "
    "bring brings brought buy buys bought feed feeds fed build "
    "builds built sleep sleeps slept keep keeps kept leave "
    "left tell tells told drive drives drove draw draws drew "
    "wash bake cook clean brush kiss hug help wave clap sing sang "
    "dance cry laugh smile blow blew cut pour stir wipe pick lick "
    "bite bit chew climb crawl roll splash".split())
# Complex prepositions collapsed to one relation token, as the Stanford
# collapsed-dependencies stage inside the Java SPICE does ("on top of"
# -> on_top_of). Longest match wins; names are the "_"-joined surface
# forms Stanford emits.
MULTIWORD_PREPOSITIONS = tuple(sorted((
    tuple(p.split()) for p in (
        "in the middle of", "on the side of", "at the top of",
        "at the bottom of", "on the back of", "at the back of",
        "on the edge of", "at the edge of",
        "on top of", "in front of", "in back of", "out from under",
        "next to", "close to", "near to", "out of", "inside of",
        "outside of", "away from", "far from", "along with",
        "together with", "instead of", "because of", "ahead of",
        "across from", "up against")),
    key=len, reverse=True))

COMMON_ADJECTIVES = frozenset(
    "many few big little small large tiny huge red blue green yellow orange purple "
    "pink brown black white gray grey good bad nice pretty cute funny "
    "happy sad old new young hot cold warm wet dry soft hard clean dirty "
    "fast slow tall short long round empty full heavy light loud quiet "
    "hungry sleepy silly fuzzy furry shiny broken striped spotted wooden "
    "plastic".split())

try:  # synonym-aware tuple matching when wordnet data exists locally
    from nltk.corpus import wordnet as _wn
    _wn.synsets("dog")
    _HAVE_WORDNET = True
except Exception:  # pragma: no cover - no wordnet data installed
    _wn = None
    _HAVE_WORDNET = False


# irregular lemmas the suffix rules can't reach (morphy handles these
# when wordnet data exists; this map keeps the no-data path consistent)
_IRREGULAR_LEMMA = {
    "children": "child", "men": "man", "women": "woman", "feet": "foot",
    "teeth": "tooth", "mice": "mouse", "geese": "goose",
    "went": "go", "gone": "go", "going": "go", "goes": "go",
    "did": "do", "does": "do", "doing": "do", "done": "do",
    "has": "have", "had": "have", "having": "have",
    "was": "be", "were": "be", "been": "be", "being": "be",
    "fell": "fall", "ran": "run", "sat": "sit", "ate": "eat",
    "saw": "see", "seen": "see", "got": "get", "took": "take",
    "gave": "give", "made": "make", "found": "find", "threw": "throw",
    "held": "hold", "drank": "drink", "flew": "fly", "swam": "swim",
    "wore": "wear", "rode": "ride", "drew": "draw", "drove": "drive",
    "stood": "stand", "came": "come", "knew": "know", "said": "say",
    "thought": "think", "caught": "catch", "brought": "bring",
    "bought": "buy", "fed": "feed", "built": "build", "slept": "sleep",
    "kept": "keep", "left": "leave", "told": "tell",
}

_VOWELS = set("aeiou")


def _undouble_or_e(stem: str) -> str:
    """After stripping -ing/-ed: undo consonant doubling (running -> run)
    or restore a dropped final e on a CVC stem (riding -> ride)."""
    if len(stem) >= 3 and stem[-1] == stem[-2] \
            and stem[-1] not in _VOWELS and stem[-1] not in "lsz":
        return stem[:-1]
    if 3 <= len(stem) <= 4 and stem[-1] not in _VOWELS \
            and stem[-1] not in "wxy" and stem[-2] in _VOWELS \
            and stem[-3] not in _VOWELS:
        # short CVC stems dropped an e (rid->ride, chas->chase); longer
        # stems did not (travel, visit)
        return stem + "e"
    return stem


def _lemma(word: str, pos: str = "v") -> str:
    """Light lemmatizer (WordNet morphy when available). pos "n" keeps
    -ing/-ed nouns intact (building, painting); pos "v" strips them."""
    if word in _IRREGULAR_LEMMA:
        return _IRREGULAR_LEMMA[word]
    if _HAVE_WORDNET:
        m = _wn.morphy(word, "n" if pos == "n" else "v") \
            or _wn.morphy(word)
        if m:
            return m
    for suf, rep in (("sses", "ss"), ("ies", "y"), ("shes", "sh"),
                     ("ches", "ch"), ("xes", "x"), ("zes", "z")):
        if word.endswith(suf) and len(word) > len(suf) + 1:
            return word[:-len(suf)] + rep
    if pos != "n":
        for suf in ("ing", "ed"):
            if word.endswith(suf) and len(word) > len(suf) + 2:
                return _undouble_or_e(word[:-len(suf)])
    if word.endswith("s") and len(word) > 3 \
            and not word.endswith(("ss", "us", "is")):
        return word[:-1]
    return word


def _tag(tokens: Sequence[str]) -> List[str]:
    """Shallow POS: DET/PRON/PREP/CONJ/COP/AUX/ADV/INTJ/VERB/ADJ/NOUN."""
    tags = []
    for i, w in enumerate(tokens):
        if w in DETERMINERS:
            t = "DET"
        elif w in PRONOUNS:
            t = "PRON"
        elif w in PREPOSITIONS or "_" in w:
            t = "PREP"  # "_" marks a merged multiword preposition
        elif w in CONJUNCTIONS:
            t = "CONJ"
        elif w in COPULAS:
            t = "COP"
        elif w in AUXILIARIES:
            t = "AUX"
        elif w in ADVERBS:
            t = "ADV"
        elif w in INTERJECTIONS and i == 0:
            t = "INTJ"
        elif w in COMMON_VERBS:
            # NP position ("the watch", "a drink"): a known verb form
            # right after a determiner/adjective is a noun head, as the
            # Stanford tagger resolves it
            t = "NOUN" if tags and tags[-1] in ("DET", "ADJ") else "VERB"
        elif _lemma(w) in COMMON_VERBS:
            # lemma membership catches inflections not enumerated above
            # ("washes" -> wash); additionally the direct-object slot
            # ("eating leaves") prefers the nominal reading
            t = ("NOUN" if tags and tags[-1] in ("DET", "ADJ", "VERB")
                 else "VERB")
        elif w in COMMON_ADJECTIVES:
            t = "ADJ"
        elif w.endswith("ly") and len(w) > 4:
            t = "ADV"
        elif w.endswith("ing") and len(w) > 4:
            # gerund/participle — except in NP position ("a tall
            # building", "the painting"), where -ing words are nouns
            t = "NOUN" if tags and tags[-1] in ("DET", "ADJ") else "VERB"
        elif w.endswith("ed") and len(w) > 4:
            t = "VERB"  # participle ("a bus parked on the street")
        else:
            t = "NOUN"
        tags.append(t)
    # have/has/had head a direct object as MAIN verbs ("mommy has a
    # cup") but stay AUX before a participle ("has eaten")
    for i, w in enumerate(tokens):
        if w in ("have", "has", "had") and tags[i] == "AUX":
            j = i + 1
            while j < len(tokens) and tags[j] in ("DET", "ADJ", "ADV"):
                j += 1
            if j < len(tokens) and tags[j] == "NOUN":
                tags[i] = "VERB"
    return tags


def _merge_multiword_prepositions(tokens: List[str]) -> List[str]:
    """Collapse complex prepositions into one "_"-joined token (longest
    match first), mirroring Stanford's collapsed dependencies: "the cat
    on top of the shelf" parses to (cat, on_top_of, shelf)."""
    out: List[str] = []
    i = 0
    n = len(tokens)
    while i < n:
        for mwe in MULTIWORD_PREPOSITIONS:
            if tuple(tokens[i:i + len(mwe)]) == mwe:
                out.append("_".join(mwe))
                i += len(mwe)
                break
        else:
            out.append(tokens[i])
            i += 1
    return out


Tuple_ = Tuple[str, ...]


def parse_tuples(sentence: str) -> Set[Tuple_]:
    """Extract scene-graph tuples from a space-tokenized caption.

    Grammar (the SPICE paper's proposition inventory, Anderson et al.
    2016 figure 1, on shallow-parseable declaratives):
      objects:    head noun of each noun phrase ("tennis court" -> court)
      attributes: adjectives modifying a noun (pre-nominal or copular),
                  noun-compound modifiers ((court, tennis)), and
                  object-less verbs ((girl, stand) for "a girl standing")
      relations:  (subject-head, verb, object-head) for adjacent direct
                  objects, (left-head, preposition, right-head) for
                  prepositions
    """
    tokens = [t for t in sentence.lower().split() if t.isalnum() or "'" in t]
    tokens = _merge_multiword_prepositions(tokens)
    tags = _tag(tokens)
    tuples: Set[Tuple_] = set()

    # contiguous noun runs: the last noun is the NP head, earlier nouns
    # are compound modifiers ("tennis court" -> object (court,) +
    # attribute (court, tennis))
    heads = []  # (index, lemma) of run heads, in order
    i = 0
    while i < len(tokens):
        if tags[i] != "NOUN":
            i += 1
            continue
        j = i
        while j + 1 < len(tokens) and tags[j + 1] == "NOUN":
            j += 1
        head = _lemma(tokens[j], "n")
        heads.append((j, head))
        tuples.add((head,))
        for k in range(i, j):
            tuples.add((head, _lemma(tokens[k], "n")))
        i = j + 1

    # attributes: ADJ (ADJ)* NOUN-run, and "NOUN COP (ADV)* ADJ"
    for i, (w, t) in enumerate(zip(tokens, tags)):
        if t != "ADJ":
            continue
        j = i + 1
        while j < len(tokens) and tags[j] == "ADJ":
            j += 1
        if j < len(tokens) and tags[j] == "NOUN":
            while j + 1 < len(tokens) and tags[j + 1] == "NOUN":
                j += 1  # attach to the NP head
            tuples.add((_lemma(tokens[j], "n"), w))
        k = i - 1
        while k >= 0 and tags[k] in ("ADV", "COP"):
            if tags[k] == "COP":
                k -= 1
                while k >= 0 and tags[k] == "DET":
                    k -= 1
                if k >= 0 and tags[k] == "NOUN":
                    tuples.add((_lemma(tokens[k], "n"), w))
                break
            k -= 1

    def _left_head(i):
        return next((n for j, n in reversed(heads) if j < i), None)

    def _right_head(i):
        return next((n for j, n in heads if j > i), None)

    # relations: VERB/PREP pivots between NP heads. A verb takes a direct
    # object only when the next NP follows with no intervening pivot
    # ("a dog running in the grass" is (dog, run) + (dog, in, grass),
    # not (dog, run, grass)).
    for i, t in enumerate(tags):
        if t not in ("VERB", "PREP"):
            continue
        left, right = _left_head(i), _right_head(i)
        pred = _lemma(tokens[i]) if t == "VERB" else tokens[i]
        if t == "VERB":
            j = i + 1
            adjacent = None
            while j < len(tokens):
                if tags[j] == "NOUN":
                    adjacent = _right_head(j - 1)
                    break
                if tags[j] not in ("DET", "ADJ", "ADV"):
                    break
                j += 1
            if left and adjacent:
                tuples.add((left, pred, adjacent))
            elif left and not adjacent:
                # object-less verb -> attribute (paper: (girl, standing))
                tuples.add((left, pred))
            elif adjacent:
                # imperative: "throw the ball" -> (you, throw, ball)
                tuples.add(("you", pred, adjacent))
        else:
            if left and right:
                tuples.add((left, pred, right))
    return tuples


def _synset_key(word: str) -> FrozenSet[str]:
    if _HAVE_WORDNET:
        syn = frozenset(s.name() for s in _wn.synsets(word))
        if syn:
            return syn
    return frozenset((word,))


def _tuples_match(a: Tuple_, b: Tuple_) -> bool:
    if len(a) != len(b):
        return False
    return all(x == y or (_synset_key(x) & _synset_key(y))
               for x, y in zip(a, b))


def _f1(cand: Set[Tuple_], ref: Set[Tuple_]) -> float:
    if not cand and not ref:
        return 1.0
    if not cand or not ref:
        return 0.0
    matched_c = sum(1 for c in cand
                    if any(_tuples_match(c, r) for r in ref))
    matched_r = sum(1 for r in ref
                    if any(_tuples_match(r, c) for c in cand))
    p = matched_c / len(cand)
    r = matched_r / len(ref)
    return 2 * p * r / (p + r) if p + r else 0.0


def sentence_spice(references: Sequence[str], hypothesis: str) -> float:
    ref_tuples: Set[Tuple_] = set()
    for ref in references:
        ref_tuples |= parse_tuples(ref)
    return _f1(parse_tuples(hypothesis), ref_tuples)


def spice(list_of_references: List[List[str]],
          hypotheses: List[str]) -> float:
    """Corpus SPICE = mean sentence F1 (pycocoevalcap contract)."""
    if not hypotheses:
        return 0.0
    return sum(sentence_spice(refs, hyp)
               for refs, hyp in zip(list_of_references, hypotheses)
               ) / len(hypotheses)
