"""Word-level analyses: POS tagging, word-category grouping, rating joins:
a copy of ``multimodal_baby_tpu/analysis/word_analysis.py`` on the port's
tokenizer and SPICE lexicon, kept so that the port imports nothing of the
JAX package.

Capability parity with the CogSci toolchain's pos_tags.py (spaCy/stanza
tagging with cache), word_categories.py (hand-curated category membership)
and word_ratings.py (external norm joins) — reimplemented around the
per-word tables produced by analysis.processing.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional

# The hand-curated SAYCam word categories of the CogSci analyses
# (reference analysis_tools/word_categories.py `pos_subcats`: every vocab
# word with freq >= 24 was manually labelled; these are the "typical"
# members of the categories the paper keeps after filtering out the
# sounds/furniture_rooms/outside/people subcategories and the ambiguous
# verb classes). The lists are curated *data* — the recipe is the data —
# restructured here as a flat category->words table.
DEFAULT_WORD_CATEGORIES: Dict[str, List[str]] = {
    # noun subcategories
    "animals": ("kitty bear bunny doggy duck cow sheep kitties ducks fish "
                "birds horse birdy hippo birdies doggies bird giraffe dog "
                "dinosaur lamb mouse chick cows pig lion cat "
                "butterfly").split(),
    "vehicles": "train car truck cars boat trucks tractor wagon".split(),
    "toys": "ball puzzle balloon balls blocks dolly doh".split(),
    "food_drink": ("water banana bread eggs egg milk apple browns jam "
                   "juice grapes biscuit strawberry rice fruit sushi "
                   "hashbrowns coffee puree").split(),
    "clothing": "shoes socks shirt pants jacket sock shoe hat".split(),
    "body_parts": ("hand foot mouth hands head feet teeth nose lap toes "
                   "face belly hair eyes").split(),
    "household": ("cup bottle brush bucket spoon bag box bowl plate "
                  "sandpit cups boxes").split(),
    "places": "beach farm library store playground park".split(),
    "games_routines": "game nap breaky".split(),
    # verb subcategories
    "trans. verb": ("let make take say find show help pick says watch use "
                    "love push throw making wear thank wash bring grab "
                    "said press cut drink made saying hear dump lift makes "
                    "carry pat tell called feed touch drinking wants pull "
                    "cook took wonder").split(),
    "intrans. verb": ("go going gon come walk goes gone sit coming went "
                      "work stand fell walking sitting fall comes talking "
                      "pooing standing run sleep roar came cluck happens "
                      "running stay bark works").split(),
}

# words the reference excludes from word-level analyses
# (word_categories.py `untypical_words`: possessives, negations,
# be/do/modal verbs, contractions, quantifiers, POS-ambiguous, <unk>)
UNTYPICAL_WORDS = frozenset("""
's s not n't nt be being been am 'm m are 're re aren't arent were
weren't werent is isn't isnt was wasn't wasnt do don't dont does doesn't
doesnt did didn't didnt done have 've ve will 'll ll
i'm im you're youre we're they're theyre he's hes she's shes it's
i've ive you've youve we've weve i'll you'll we'll he'll she'll it'll
here's heres there's theres that's thats what's whats where's wheres
let's lets lot lots bit one help looking rub boop bye love <unk>
""".split())


def load_word_categories(path=None) -> Dict[str, List[str]]:
    if path is None:
        return dict(DEFAULT_WORD_CATEGORIES)
    with open(path) as f:
        return json.load(f)


def word_to_category(categories: Dict[str, List[str]]) -> Dict[str, str]:
    return {w: c for c, words in categories.items() for w in words}


def pos_tag(words: Iterable[str], cache_path=None) -> Dict[str, str]:
    """Universal-POS tags per word via spaCy, with a JSON cache
    (pos_tags.py pattern). Falls back to a tiny closed-class lexicon when
    no spaCy model is installed."""
    words = list(dict.fromkeys(words))
    cache: Dict[str, str] = {}
    if cache_path and Path(cache_path).exists():
        cache = json.loads(Path(cache_path).read_text())
    missing = [w for w in words if w not in cache]

    if missing:
        from multimodal_baby_tpu_torch.data.tokenizer import _get_spacy
        nlp = _get_spacy()
        if nlp is not None:
            for w in missing:
                doc = nlp(w)
                cache[w] = doc[0].pos_ if len(doc) else "X"
        else:
            # no spaCy model installed: shallow lexicon tagger (the same
            # closed-class inventory + suffix heuristics the SPICE parser
            # uses, evaluation/spice.py), far better than all-NOUN
            from multimodal_baby_tpu_torch.evaluation import spice as _sp
            for w in missing:
                lw = w.lower()
                if lw in _sp.DETERMINERS:
                    cache[w] = "DET"
                elif lw in _sp.PRONOUNS:
                    cache[w] = "PRON"
                elif lw in _sp.PREPOSITIONS:
                    cache[w] = "ADP"
                elif lw in _sp.CONJUNCTIONS:
                    cache[w] = "CCONJ"
                elif lw in _sp.COPULAS or lw in _sp.AUXILIARIES:
                    cache[w] = "AUX"
                elif lw in _sp.INTERJECTIONS:
                    cache[w] = "INTJ"
                elif lw in _sp.COMMON_VERBS:
                    cache[w] = "VERB"
                elif lw in _sp.COMMON_ADJECTIVES:
                    cache[w] = "ADJ"
                elif lw in _sp.ADVERBS or (lw.endswith("ly")
                                           and len(lw) > 4):
                    cache[w] = "ADV"
                elif lw.isdigit():
                    cache[w] = "NUM"
                elif lw.endswith("ing") and len(lw) > 5:
                    cache[w] = "VERB"
                else:
                    cache[w] = "NOUN" if lw.isalpha() else "X"

    if cache_path:
        Path(cache_path).parent.mkdir(parents=True, exist_ok=True)
        Path(cache_path).write_text(json.dumps(cache))
    return {w: cache[w] for w in words}


# The CogSci paper's syntactic-category compression of POS tags
# (reference analysis_tools/pos_tags.py `pos_mappings['syntactic
# category']`, expressed over universal POS instead of Penn tags):
# every word lands in {noun, verb, adjective, adverb, function word,
# cardinal number, .}
SYNTACTIC_CATEGORY = {
    "NOUN": "noun", "PROPN": "noun",
    "VERB": "verb",
    "ADJ": "adjective",
    "ADV": "adverb",
    "NUM": "cardinal number",
    "DET": "function word", "PRON": "function word",
    "ADP": "function word", "AUX": "function word",
    "CCONJ": "function word", "SCONJ": "function word",
    "PART": "function word", "CONJ": "function word",
    "INTJ": ".", "PUNCT": ".", "SYM": ".", "X": ".", "SPACE": ".",
}


def syntactic_category(pos: str) -> str:
    """Universal POS -> the paper's 7 syntactic categories."""
    return SYNTACTIC_CATEGORY.get(pos, ".")


def per_category_summary(word_summary: "pandas.DataFrame",
                         categories: Optional[Dict[str, List[str]]] = None,
                         exclude_untypical: bool = True
                         ) -> "pandas.DataFrame":
    """Aggregate a per-word table (analysis.processing.per_word_summary) by
    word category, token-count weighted. Untypical words (possessives,
    contractions, POS-ambiguous — word_categories.py `untypical_words`)
    are dropped like the reference analyses do."""
    import pandas as pd

    mapping = word_to_category(categories or DEFAULT_WORD_CATEGORIES)
    df = word_summary.copy()
    if exclude_untypical:
        df = df[~df["token"].isin(UNTYPICAL_WORDS)]
    df["category"] = df["token"].map(mapping).fillna("other")
    df["weighted_ce"] = df["mean_ce"] * df["count"]
    agg = (df.groupby("category")
           .agg(total_count=("count", "sum"),
                n_words=("token", "nunique"),
                weighted_ce=("weighted_ce", "sum"))
           .reset_index())
    agg["mean_ce"] = agg["weighted_ce"] / agg["total_count"]
    return agg.drop(columns=["weighted_ce"])


def join_ratings(word_summary: "pandas.DataFrame", ratings_csv,
                 word_column: str = "word") -> "pandas.DataFrame":
    """Join external word norms/ratings (word_ratings.py pattern)."""
    import pandas as pd

    ratings = pd.read_csv(ratings_csv)
    return word_summary.merge(
        ratings, left_on="token", right_on=word_column, how="left")
