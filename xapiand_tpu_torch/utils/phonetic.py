"""Language-aware Soundex phonetic encodings.

Reference parity target: src/phonetic/ (english/french/german/spanish
soundex variants) used for fuzzy string sort metrics
(keymaker.h StringKey w/ soundex metric).

English follows the classic American Soundex (letter + 3 digits); the
French/German/Spanish variants apply per-language code tables in the same
frame - behavioural analogs of the reference's per-language classes.
"""

from __future__ import annotations

import unicodedata

_EN = {**{c: "1" for c in "bfpv"}, **{c: "2" for c in "cgjkqsxz"},
       **{c: "3" for c in "dt"}, "l": "4", **{c: "5" for c in "mn"},
       "r": "6"}

_DE = {**{c: "1" for c in "bpfvw"}, **{c: "2" for c in "cgkqxszß"},
       **{c: "3" for c in "dt"}, "l": "4", **{c: "5" for c in "mn"},
       "r": "6"}

_FR = {**{c: "1" for c in "bp"}, **{c: "2" for c in "ckq"},
       **{c: "3" for c in "dt"}, "l": "4", **{c: "5" for c in "mn"},
       "r": "6", **{c: "7" for c in "gj"}, **{c: "8" for c in "xzs"},
       **{c: "9" for c in "fv"}}

_ES = {**{c: "1" for c in "bpv"}, **{c: "2" for c in "cgjkqsxz"},
       **{c: "3" for c in "dt"}, "l": "4", **{c: "5" for c in "mnñ"},
       "r": "6"}

_TABLES = {"english": _EN, "en": _EN, "german": _DE, "de": _DE,
           "french": _FR, "fr": _FR, "spanish": _ES, "es": _ES}


def _strip_accents(s: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", s)
                   if unicodedata.category(c) != "Mn")


def soundex(word: str, lang: str = "english", length: int = 4) -> str:
    table = _TABLES.get(lang.lower(), _EN)
    w = _strip_accents(word.lower())
    w = "".join(c for c in w if c.isalpha() or c == "ß")
    if not w:
        return ""
    first = w[0].upper()
    codes = []
    prev = table.get(w[0], "")
    for c in w[1:]:
        code = table.get(c, "")
        if code and code != prev:
            codes.append(code)
        if c not in "hw":  # h/w do not separate duplicate codes
            prev = code
    out = first + "".join(codes)
    return (out + "0" * length)[:length]


def soundex_similarity(a: str, b: str, lang: str = "english") -> float:
    sa, sb = soundex(a, lang), soundex(b, lang)
    if not sa or not sb:
        return 0.0
    if sa == sb:
        return 1.0
    same = sum(1 for x, y in zip(sa, sb) if x == y)
    return same / max(len(sa), len(sb))
