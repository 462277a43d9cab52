"""Snowball stemming with ISO language-code resolution (the port's own
version of ``xapiand_tpu/analysis/stem.py``, whose top-level nltk import
the port cannot make: the machine that runs it on the card has no nltk).

- English goes through the native library's Porter2
  (``native/native.cpp stem_english``, exported per word by
  ``native/stem_export.cpp``), the stemmer the inverter uses and that
  ``tests/test_native_inverter.py`` holds equal to nltk's. A word that is
  not ASCII goes to nltk, as the JAX package stems it: the native
  stemmer counts bytes where nltk counts characters, so where nltk is
  missing such a word raises ``StemError`` rather than take other terms.
- The languages of ``stem_extra*.py`` (pure Python) stem as in the JAX
  package.
- The other Snowball languages use nltk where it imports; where it does
  not, building their ``Stem`` raises ``StemError`` naming the language,
  rather than indexing unstemmed terms.
- A language neither list knows resolves to None (no stemming), as in
  the JAX package (``stem.py:48-49``).
"""

from __future__ import annotations

from functools import lru_cache

from xapiand_tpu_torch.analysis.stem_extra import EXTRA_STEMMERS
from xapiand_tpu_torch.analysis.stem_extra2 import EXTRA_STEMMERS_2

# the JAX file's aliases (stem.py:17-28)
_LANG_ALIASES = {
    "ar": "arabic", "da": "danish", "nl": "dutch", "en": "english",
    "fi": "finnish", "fr": "french", "de": "german", "hu": "hungarian",
    "it": "italian", "no": "norwegian", "nb": "norwegian", "nn": "norwegian",
    "pt": "portuguese", "ro": "romanian", "ru": "russian", "es": "spanish",
    "sv": "swedish", "porter": "porter",
    "id": "indonesian", "ga": "irish", "ne": "nepali",
    "early_english": "earlyenglish",
    "hy": "armenian", "eu": "basque", "ca": "catalan",
    "kraaij-pohlmann": "kraaij_pohlmann",
    "lt": "lithuanian", "ta": "tamil", "tr": "turkish",
}
# nltk's SnowballStemmer.languages (nltk 3.x), named here so that the
# resolution does not depend on nltk being importable
NLTK_LANGUAGES = ("arabic", "danish", "dutch", "english", "finnish",
                  "french", "german", "hungarian", "italian", "norwegian",
                  "porter", "portuguese", "romanian", "russian", "spanish",
                  "swedish")

EXTRA_STEMMERS.update(EXTRA_STEMMERS_2)

_SUPPORTED = set(NLTK_LANGUAGES) | set(EXTRA_STEMMERS)


class StemError(ValueError):
    pass


def resolve_language(lang: str | None) -> str | None:
    """Resolve a language spec to a Snowball language name, or None for
    'none'/'' (no stemming)."""
    if not lang or lang.lower() in ("none", "false"):
        return None
    lang = lang.lower()
    lang = _LANG_ALIASES.get(lang, lang)
    if lang not in _SUPPORTED:
        return None  # unsupported languages degrade to no stemming
    return lang


def _nltk_snowball():
    """nltk's SnowballStemmer class, or None where nltk does not import."""
    try:
        from nltk.stem.snowball import SnowballStemmer
    except ImportError:
        return None
    return SnowballStemmer


@lru_cache(maxsize=32)
def _stemmer(lang: str):
    cls = _nltk_snowball()
    if cls is None:
        raise StemError(f"stemming {lang!r} needs nltk, which does not "
                        "import here (ASCII English and the languages "
                        "of stem_extra*.py stem without it)")
    return cls(lang).stem


def _english(word: str) -> str:
    if not word.isascii():
        return _stemmer("english")(word)   # raises by name without nltk
    from xapiand_tpu_torch import native

    return native.stem_english(word)


@lru_cache(maxsize=262144)
def _stem_cached(lang: str, word: str) -> str:
    """Vocabulary repeats heavily during bulk indexing; memoising the
    Snowball call is the single biggest host-side analysis speedup."""
    extra = EXTRA_STEMMERS.get(lang)
    if extra is not None:
        return extra(word)
    if lang == "english":
        return _english(word)
    return _stemmer(lang)(word)


class Stem:
    """Callable stemmer, Xapian::Stem-alike."""

    def __init__(self, lang: str | None = "english"):
        self.language = resolve_language(lang)
        if self.language and self.language != "english" \
                and self.language not in EXTRA_STEMMERS:
            _stemmer(self.language)   # raises by name without nltk

    def __call__(self, word: str) -> str:
        if self.language is None:
            return word
        return _stem_cached(self.language, word)

    def __repr__(self):
        return f"Stem({self.language or 'none'})"


def stem_word(word: str, lang: str | None = "english") -> str:
    return Stem(lang)(word)
