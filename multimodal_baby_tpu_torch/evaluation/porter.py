"""The Porter (1980) suffix-stripping stemmer, with the rules of NLTK's
default ``NLTK_EXTENSIONS`` mode, for METEOR's stem stage (``meteor.py``).

M. F. Porter, "An algorithm for suffix stripping", Program 14(3),
130-137 (1980). The extensions over the paper, as NLTK's stemmer makes
them in its default mode:

- a table of irregular forms (sky/skies, dying, lying, tying, news,
  innings, outings, cannings, howe, proceed, exceed, succeed);
- words of at most two letters are returned as they are;
- step 1a: a four-letter ``-ies`` word becomes ``-ie`` (ties -> tie);
- step 1b: ``-ied`` becomes ``-ie`` in a four-letter word, else ``-i``;
- condition *o also holds for a two-letter vowel-consonant stem;
- step 1c: ``y -> i`` only after a consonant that is not the whole stem;
- step 2: ``-alli`` becomes ``-al`` first (then step 2 again), ``-bli ->
  -ble`` takes the place of ``-abli -> -able``, and ``-fulli -> -ful`` and
  ``-logi -> -log`` are added.

The port carries this stemmer so that the scorer stems the same way on
every machine, with or without nltk installed;
``tests/test_torch_textgen.py`` holds ``stem`` equal to nltk's
``PorterStemmer().stem``, word for word, over the packaged vocabulary
and the scorers' test corpora.

A suffix rule list applies its first rule whose suffix the word ends
with: when that rule's condition fails the word is returned unchanged,
and the rules after it are not tried.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

_VOWELS = frozenset("aeiou")

_IRREGULAR = {
    "sky": ("sky", "skies"), "die": ("dying",), "lie": ("lying",),
    "tie": ("tying",), "news": ("news",), "inning": ("innings", "inning"),
    "outing": ("outings", "outing"), "canning": ("cannings", "canning"),
    "howe": ("howe",), "proceed": ("proceed",), "exceed": ("exceed",),
    "succeed": ("succeed",)}
_POOL = {form: base for base, forms in _IRREGULAR.items() for form in forms}

# (suffix, replacement, condition on the stem left without the suffix)
Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _consonant(word: str, i: int) -> bool:
    """A letter other than a, e, i, o, u, and other than a y after a
    consonant (a run of y's alternates, counted back from its start)."""
    if word[i] in _VOWELS:
        return False
    if word[i] != "y":
        return True
    flip = False
    while i > 0 and word[i] == "y":
        flip = not flip
        i -= 1
    return (word[i] not in _VOWELS) != flip


def measure(stem: str) -> int:
    """m in [C](VC){m}[V]: the number of vowel-consonant transitions."""
    cv = "".join("c" if _consonant(stem, i) else "v"
                 for i in range(len(stem)))
    return cv.count("vc")


def _positive(stem: str) -> bool:
    return measure(stem) > 0


def _above_one(stem: str) -> bool:
    return measure(stem) > 1


def _has_vowel(stem: str) -> bool:
    return any(not _consonant(stem, i) for i in range(len(stem)))


def _double_consonant(word: str) -> bool:
    """*d: the word ends with two equal consonants."""
    return (len(word) >= 2 and word[-1] == word[-2]
            and _consonant(word, len(word) - 1))


def _cvc(word: str) -> bool:
    """*o: consonant-vowel-consonant at the end, the last not w, x or y;
    or the whole word is vowel-consonant."""
    n = len(word)
    if (n >= 3 and _consonant(word, n - 3) and not _consonant(word, n - 2)
            and _consonant(word, n - 1) and word[-1] not in "wxy"):
        return True
    return n == 2 and not _consonant(word, 0) and _consonant(word, 1)


def _apply(word: str, rules: Sequence[Rule]) -> str:
    for suffix, replacement, cond in rules:
        if suffix == "*d":  # a double consonant, its last letter kept once
            if _double_consonant(word):
                stem = word[:-2]
                return stem + replacement if cond is None or cond(stem) \
                    else word
            continue
        if word.endswith(suffix):
            stem = word[:len(word) - len(suffix)]
            return stem + replacement if cond is None or cond(stem) \
                else word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return word[:-3] + "ie"
    return _apply(word, [("sses", "ss", None), ("ies", "i", None),
                         ("ss", "ss", None), ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return word[:-3] + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = word[:-3]
        return stem + "ee" if measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix) and _has_vowel(word[:-len(suffix)]):
            stem = word[:-len(suffix)]
            break
    else:
        return word
    return _apply(stem, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", stem[-1:], lambda _: stem[-1] not in "lsz"),
        ("", "e", lambda s: measure(s) == 1 and _cvc(s))])


def _step1c(word: str) -> str:
    return _apply(word, [("y", "i", lambda s: len(s) > 1
                          and _consonant(s, len(s) - 1))])


_STEP2 = [
    ("ational", "ate", _positive), ("tional", "tion", _positive),
    ("enci", "ence", _positive), ("anci", "ance", _positive),
    ("izer", "ize", _positive), ("bli", "ble", _positive),
    ("alli", "al", _positive), ("entli", "ent", _positive),
    ("eli", "e", _positive), ("ousli", "ous", _positive),
    ("ization", "ize", _positive), ("ation", "ate", _positive),
    ("ator", "ate", _positive), ("alism", "al", _positive),
    ("iveness", "ive", _positive), ("fulness", "ful", _positive),
    ("ousness", "ous", _positive), ("aliti", "al", _positive),
    ("iviti", "ive", _positive), ("biliti", "ble", _positive),
    ("fulli", "ful", _positive),
    # -logi: the measure is taken with the l
    ("logi", "log", lambda s: _positive(s + "l"))]


def _step2(word: str) -> str:
    if word.endswith("alli") and _positive(word[:-4]):
        return _step2(word[:-4] + "al")
    return _apply(word, _STEP2)


_STEP3 = [("icate", "ic", _positive), ("ative", "", _positive),
          ("alize", "al", _positive), ("iciti", "ic", _positive),
          ("ical", "ic", _positive), ("ful", "", _positive),
          ("ness", "", _positive)]

_STEP4 = [(s, "", _above_one) for s in (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent")] + [
    ("ion", "", lambda s: _above_one(s) and s[-1:] in ("s", "t"))] + [
    (s, "", _above_one) for s in ("ou", "ism", "ate", "iti", "ous", "ive",
                                  "ize")]


def _step5a(word: str) -> str:
    if word.endswith("e"):
        stem = word[:-1]
        m = measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply(word, [("ll", "l", lambda _: measure(word[:-1]) > 1)])


def stem(word: str) -> str:
    """The stem of ``word``, lowercased."""
    w = word.lower()
    if w in _POOL:
        return _POOL[w]
    if len(word) <= 2:
        return w
    for step in (_step1a, _step1b, _step1c, _step2):
        w = step(w)
    w = _apply(w, _STEP3)
    w = _apply(w, _STEP4)
    return _step5b(_step5a(w))
