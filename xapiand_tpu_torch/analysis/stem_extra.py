"""Snowball stemmers for languages NLTK does not ship.

Faithful Python ports of the public Snowball algorithms (snowballstem.org;
the reference compiles the same .sbl sources, src/xapian/languages/):
indonesian, irish, nepali, and earlyenglish (the Porter variant with
-est/-eth handling for Early Modern English). Each port follows the
Snowball control flow: ``among`` picks the longest matching affix and
falls back to shorter matches only across gating tests; region checks
(R1/R2/RV) are cursor positions from the word start.
"""

from __future__ import annotations

_VOWELS_EN = "aeiouy"


# ---------------------------------------------------------------------------
# indonesian (Porter for Bahasa Indonesia; indonesian.sbl)
# ---------------------------------------------------------------------------

_ID_VOWELS = "aeiou"


def stem_indonesian(word: str) -> str:
    measure = sum(1 for c in word if c in _ID_VOWELS)
    if measure <= 2:
        return word
    prefix = 0

    # remove_particle (backward; longest first)
    for suf in ("kah", "lah", "pun"):
        if word.endswith(suf):
            word = word[:-3]
            measure -= 1
            break
    if measure <= 2:
        return word
    # remove_possessive_pronoun
    for suf in ("nya", "ku", "mu"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            measure -= 1
            break
    if measure <= 2:
        return word

    def remove_suffix(w, m, pfx):
        # gates: kan unless prefix in {ke/peng(3), per(2)}; an unless
        # prefix di/meng/ter(1); i unless prefix>2 or word ends -si
        if w.endswith("kan") and pfx not in (2, 3):
            return w[:-3], m - 1, True
        if w.endswith("an") and pfx != 1:
            return w[:-2], m - 1, True
        if w.endswith("i") and pfx <= 2 and not w.endswith("si"):
            return w[:-1], m - 1, True
        return w, m, False

    def first_order(w, m):
        # longest-first with gate fallback
        if w.startswith("meny") and len(w) > 4 and w[4] in _ID_VOWELS:
            return "s" + w[4:], m - 1, 1, True
        if w.startswith("peny") and len(w) > 4 and w[4] in _ID_VOWELS:
            return "s" + w[4:], m - 1, 3, True
        if w.startswith("meng"):
            return w[4:], m - 1, 1, True
        if w.startswith("peng"):
            return w[4:], m - 1, 3, True
        if w.startswith("mem"):
            if len(w) > 3 and w[3] in _ID_VOWELS:
                return "p" + w[3:], m - 1, 1, True
            return w[3:], m - 1, 1, True
        if w.startswith("pem"):
            if len(w) > 3 and w[3] in _ID_VOWELS:
                return "p" + w[3:], m - 1, 3, True
            return w[3:], m - 1, 3, True
        if w.startswith("men"):
            return w[3:], m - 1, 1, True
        if w.startswith("pen"):
            return w[3:], m - 1, 3, True
        if w.startswith("ter"):
            return w[3:], m - 1, 1, True
        if w.startswith("di"):
            return w[2:], m - 1, 1, True
        if w.startswith("me"):
            return w[2:], m - 1, 1, True
        if w.startswith("ke"):
            return w[2:], m - 1, 3, True
        return w, m, 0, False

    def second_order(w, m, pfx):
        if w.startswith("belajar"):
            return "ajar" + w[7:], m - 1, 4, True
        if w.startswith("pelajar"):
            return "ajar" + w[7:], m - 1, pfx, True
        if w.startswith("ber"):
            return w[3:], m - 1, 4, True
        if w.startswith("per"):
            return w[3:], m - 1, 2, True
        if w.startswith("be") and len(w) > 4 and \
                w[2] not in _ID_VOWELS and w[3:5] == "er":
            return w[2:], m - 1, 4, True
        if w.startswith("pe"):
            return w[2:], m - 1, 2, True
        return w, m, pfx, False

    w1, m1, p1, ok = first_order(word, measure)
    if ok:
        word, measure, prefix = w1, m1, p1
        if measure > 2:
            w2, m2, removed = remove_suffix(word, measure, prefix)
            if removed:
                word, measure = w2, m2
                if measure > 2:
                    w3, m3, p3, ok2 = second_order(word, measure, prefix)
                    if ok2:
                        word, measure = w3, m3
        return word
    w2, m2, p2, ok = second_order(word, measure, prefix)
    if ok:
        word, measure, prefix = w2, m2, p2
    if measure > 2:
        w3, m3, removed = remove_suffix(word, measure, prefix)
        if removed:
            word, measure = w3, m3
    return word


# ---------------------------------------------------------------------------
# irish (irish.sbl)
# ---------------------------------------------------------------------------

_GA_VOWELS = "aeiouáéíóú"

_GA_INITIAL = [
    # longest first; (affix, replacement)
    ("d'fh", "f"), ("bhf", "f"),
    ("h-", ""), ("n-", ""), ("t-", ""), ("d'", ""), ("m'", ""), ("b'", ""),
    ("sh", "s"), ("mb", "b"), ("gc", "c"), ("nd", "d"), ("ng", "g"),
    ("bp", "p"), ("ts", "s"), ("dt", "t"), ("bh", "b"), ("ch", "c"),
    ("dh", "d"), ("fh", "f"), ("gh", "g"), ("mh", "m"), ("ph", "p"),
    ("th", "t"),
]

_GA_NOUN_R1 = ("aíochta", "íochta", "aíocht", "íocht",
               "eamh", "eabh", "aibh", "aimh", "amh", "abh", "ibh", "imh")
_GA_NOUN_R2 = ("aire", "airí", "ire", "irí")
_GA_DERIV_R2 = ("eachtúil", "achtúil", "eachta", "achta",
                "eacht", "acht", "each", "ach")
_GA_DERIV_REPL = [
    (("arcachtaí", "arcachta", "arcacht"), "arc"),
    (("gineach", "gineas", "ginis"), "gin"),
    (("grafaíochtaí", "grafaíochta", "grafaíocht",
      "grafaíoch"), "graf"),
    (("patacha", "pataigh", "patach", "paite"), "paite"),
    (("óideacha", "óideach", "óidigh"), "óid"),
]
_GA_VERB_RV = ("aímid", "aimid", "ímid", "imid", "faidh", "fidh")
_GA_VERB_R1 = ("eadh", "tear", "áil", "adh", "ain", "tar")


def stem_irish(word: str) -> str:
    for affix, repl in _GA_INITIAL:
        if word.startswith(affix):
            word = repl + word[len(affix):]
            break

    n = len(word)
    pv = p1 = p2 = n
    for i, c in enumerate(word):
        if c in _GA_VOWELS:
            pv = i + 1
            break
    i = pv
    while i < n and word[i] in _GA_VOWELS:
        i += 1
    if i < n:
        p1 = i + 1
        j = p1
        while j < n and word[j] not in _GA_VOWELS:
            j += 1
        while j < n and word[j] in _GA_VOWELS:
            j += 1
        if j < n:
            p2 = j + 1

    def in_r(pos, mark):
        return mark <= pos

    # noun_sfx: longest match gated by region (no fallback across entries
    # of different gates in the spec - matched entry's region must hold)
    cands = sorted(list(_GA_NOUN_R1) + list(_GA_NOUN_R2), key=len,
                   reverse=True)
    for suf in cands:
        if word.endswith(suf):
            mark = p1 if suf in _GA_NOUN_R1 else p2
            if in_r(len(word) - len(suf), mark):
                word = word[: -len(suf)]
            break
    # deriv
    deriv = [(s, None) for s in _GA_DERIV_R2]
    for sufs, repl in _GA_DERIV_REPL:
        deriv.extend((s, repl) for s in sufs)
    for suf, repl in sorted(deriv, key=lambda t: -len(t[0])):
        if word.endswith(suf):
            if repl is None:
                if in_r(len(word) - len(suf), p2):
                    word = word[: -len(suf)]
            else:
                word = word[: -len(suf)] + repl
            break
    # verb_sfx
    for suf in sorted(list(_GA_VERB_RV) + list(_GA_VERB_R1), key=len,
                      reverse=True):
        if word.endswith(suf):
            mark = pv if suf in _GA_VERB_RV else p1
            if in_r(len(word) - len(suf), mark):
                word = word[: -len(suf)]
            break
    return word


# ---------------------------------------------------------------------------
# nepali (nepali.sbl; suffix tables transcribed from the published spec)
# ---------------------------------------------------------------------------

_NE_CAT1_DELETE = ('मार्फत', 'द्वारा', 'सँगै', 'संग', 'सँग', 'लाइ', 'लाई',
                   'पछि', 'ले', 'रत', 'मै', 'मा')
_NE_CAT1_KA = ('को', 'का', 'कि', 'की', 'कै')
_NE_CAT2_CHECK = ('ँ', 'ं', 'ै')
_NE_CAT2_CTX1 = ('यौ', 'छौ', 'नौ', 'थे')     # before ँ/ं
_NE_CAT2_CTX2 = ('त्र',)                      # before ै
_NE_CAT3 = (
    'थिइस्', 'हुनेछ', 'हुन्छ', 'नेछस्', 'नेछन्', 'इएकी', 'इएका', 'इएको',
    'िएकी', 'िएका', 'िएको', 'इछन्', 'िछन्', 'इछस्', 'िछस्', 'एछन्',
    'ेछन्', 'एछस्', 'ेछस्', 'छिन्', 'छेस्', 'छ्यौ', 'थिन्', 'थियो',
    'थियौ', 'थिस्', 'थ्यो', 'थ्यौ', 'दियो', 'देखि', 'देखी', 'लान्',
    'माथि', 'नेकै', 'नेका', 'नेको', 'नेछौ', 'होस्', 'इन्छ', 'िन्छ',
    'नेछु', 'इछौ', 'िछौ', 'इस्', 'िस्', 'ियो', 'इयो', 'एका', 'ेका',
    'एकी', 'ेकी', 'एकै', 'ेकै', 'एको', 'ेको', 'एछु', 'ेछु', 'एछौ',
    'ेछौ', 'छन्', 'छस्', 'थिए', 'पर्', 'भयो', 'हरु', 'हरू', 'िदा',
    'इदा', 'िदो', 'इदो', 'िदै', 'इदै', 'नेछ', 'इछ', 'िछ', 'एछ', 'ेछ',
    'छु', 'छे', 'छौ', 'थी', 'थे', 'दा', 'दी', 'दै', 'दो', 'नु', 'ने',
    'यो', 'यौ', 'छ',
)


def stem_nepali(word: str) -> str:
    # category 1: postpositions / case markers
    for suf in sorted(_NE_CAT1_DELETE + _NE_CAT1_KA, key=len, reverse=True):
        if word.endswith(suf):
            if suf in _NE_CAT1_KA:
                stem_part = word[: -len(suf)]
                # keep the suffix when preceded by ए / े
                if not stem_part.endswith(('ए', 'े')):
                    word = stem_part
            else:
                word = word[: -len(suf)]
            break
    # repeat: category 2 (contextual nasal/ai) then category 3 (verb forms)
    while True:
        if word.endswith(_NE_CAT2_CHECK):
            if word.endswith(('ँ', 'ं')):
                stem_part = word[:-1]
                if stem_part.endswith(_NE_CAT2_CTX1):
                    word = stem_part
            elif word.endswith('ै'):
                stem_part = word[:-1]
                if stem_part.endswith(_NE_CAT2_CTX2):
                    word = stem_part
        matched = False
        for suf in sorted(_NE_CAT3, key=len, reverse=True):
            if word.endswith(suf):
                word = word[: -len(suf)]
                matched = True
                break
        if not matched:
            break
    return word


# ---------------------------------------------------------------------------
# earlyenglish (Porter + -est/-eth; earlyenglish.sbl)
# ---------------------------------------------------------------------------

def _ee_shortv(w: str, c: int) -> bool:
    # backward: non-v_WXY at c-1, vowel at c-2, non-vowel at c-3
    if c < 3:
        return False
    return (w[c - 1] not in _VOWELS_EN + "wxY" and
            w[c - 2] in _VOWELS_EN and w[c - 3] not in _VOWELS_EN)


def stem_earlyenglish(word: str) -> str:
    y_found = False
    if word.startswith("y"):
        word = "Y" + word[1:]
        y_found = True
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS_EN:
            chars[i] = "Y"
            y_found = True
    word = "".join(chars)

    n = len(word)
    p1 = p2 = n
    i = 0
    while i < n and word[i] not in _VOWELS_EN:
        i += 1
    while i < n and word[i] in _VOWELS_EN:
        i += 1
    if i < n:
        p1 = i + 1
        j = p1
        while j < n and word[j] not in _VOWELS_EN:
            j += 1
        while j < n and word[j] in _VOWELS_EN:
            j += 1
        if j < n:
            p2 = j + 1

    def r1(c):
        return p1 <= c

    def r2(c):
        return p2 <= c

    # Step 1a
    for suf, repl in (("sses", "ss"), ("ies", "i"), ("ss", "ss"),
                      ("s", "")):
        if word.endswith(suf):
            if repl != suf:
                word = word[: -len(suf)] + repl
            break
    # Step 1b
    if word.endswith("eed"):
        if r1(len(word) - 3):
            word = word[:-1]   # eed -> ee
    else:
        for suf in ("ing", "est", "eth", "ed"):
            if word.endswith(suf):
                stem_part = word[: -len(suf)]
                if any(ch in _VOWELS_EN for ch in stem_part):
                    word = stem_part
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word.endswith(("bb", "dd", "ff", "gg", "mm",
                                        "nn", "pp", "rr", "tt")):
                        word = word[:-1]
                    elif len(word) == p1 and _ee_shortv(word, len(word)):
                        word += "e"
                break
    # Step 1c: y/Y preceded (anywhere) by a vowel -> i
    if word and word[-1] in "yY" and \
            any(ch in _VOWELS_EN for ch in word[:-1]):
        word = word[:-1] + "i"
    # Step 2 (R1)
    for suf, repl in (("ational", "ate"), ("ization", "ize"),
                      ("fulness", "ful"), ("ousness", "ous"),
                      ("iveness", "ive"), ("tional", "tion"),
                      ("biliti", "ble"), ("ation", "ate"),
                      ("alism", "al"), ("aliti", "al"), ("ousli", "ous"),
                      ("iviti", "ive"), ("entli", "ent"), ("enci", "ence"),
                      ("anci", "ance"), ("abli", "able"), ("izer", "ize"),
                      ("ator", "ate"), ("alli", "al"), ("eli", "e")):
        if word.endswith(suf):
            if r1(len(word) - len(suf)):
                word = word[: -len(suf)] + repl
            break
    # Step 3 (R1)
    for suf, repl in (("icate", "ic"), ("alize", "al"), ("iciti", "ic"),
                      ("ative", ""), ("ical", "ic"), ("ness", ""),
                      ("ful", "")):
        if word.endswith(suf):
            if r1(len(word) - len(suf)):
                word = word[: -len(suf)] + repl
            break
    # Step 4 (R2)
    for suf in ("ement", "ance", "ence", "able", "ible", "ment", "ent",
                "ism", "ate", "iti", "ous", "ive", "ize", "ion", "al",
                "er", "ic", "ou", "ant"):
        if word.endswith(suf):
            c = len(word) - len(suf)
            if r2(c):
                if suf == "ion":
                    if c > 0 and word[c - 1] in "st":
                        word = word[:c]
                else:
                    word = word[:c]
            break
    # Step 5a
    if word.endswith("e"):
        c = len(word) - 1
        if r2(c) or (r1(c) and not _ee_shortv(word, c)):
            word = word[:-1]
    # Step 5b
    if word.endswith("ll") and r2(len(word) - 1):
        word = word[:-1]

    if y_found:
        word = word.replace("Y", "y")
    return word


EXTRA_STEMMERS = {
    "indonesian": stem_indonesian,
    "irish": stem_irish,
    "nepali": stem_nepali,
    "earlyenglish": stem_earlyenglish,
}
