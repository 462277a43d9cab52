"""Unicode word tokenisation with CJK n-gram support.

Behavioural model: Xapian's TermGenerator tokeniser
(src/xapian/queryparser/termgenerator_internal.cc:139-260): words are maximal
runs of Unicode word characters; embedded apostrophes and '&' join words;
up to two trailing '+' / one '#' are kept (C++, C#); CJK runs are split into
unigrams+bigrams (cjk-tokenizer.cc). Output is lowercased NFC text with
character positions.
"""

from __future__ import annotations

import unicodedata
from typing import Iterator, NamedTuple


class Token(NamedTuple):
    text: str
    position: int  # word position (0-based, increments per emitted word unit)


def _is_word_char(ch: str) -> bool:
    cat = unicodedata.category(ch)
    return cat[0] in ("L", "N") or cat == "Mn" or cat == "Mc"


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x2E80 <= cp <= 0x9FFF       # CJK radicals..unified ideographs
        or 0x3400 <= cp <= 0x4DBF
        or 0xF900 <= cp <= 0xFAFF    # compatibility ideographs
        or 0x20000 <= cp <= 0x2FA1F
        or 0xAC00 <= cp <= 0xD7AF    # hangul syllables
        or 0x3040 <= cp <= 0x30FF    # hiragana + katakana
    )


def _is_han(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF or 0x20000 <= cp <= 0x2FA1F)


def _is_hangul(ch: str) -> bool:
    return 0xAC00 <= ord(ch) <= 0xD7AF


_jieba = None


def _segment_words(run: str) -> list[str]:
    """Dictionary word segmentation of one CJK run (the reference's
    CJKWordIterator / ICU BreakIterator path, termgenerator_internal.cc:
    139-161 + cjk-tokenizer.cc). Han text segments with the jieba
    dictionary; hangul runs are whole words (Korean is space-delimited);
    kana-only runs fall back to unigrams+bigrams (the reference without
    ICU does the same for everything)."""
    global _jieba
    if any(_is_han(c) for c in run):
        if _jieba is None:
            try:
                import logging

                import jieba

                jieba.setLogLevel(logging.WARNING)
                jieba.initialize()
                _jieba = jieba
            except Exception:
                _jieba = False
        if _jieba:
            return [w for w in _jieba.cut(run) if w.strip()]
    elif all(_is_hangul(c) for c in run):
        return [run]
    out = []
    for k, c in enumerate(run):
        out.append(c)
        if k + 1 < len(run):
            out.append(run[k: k + 2])
    return out


def tokenize(text: str, cjk_ngram: bool = True,
             cjk_words: bool = False) -> Iterator[Token]:
    """Yield lowercase word tokens with word positions.

    Non-CJK: maximal word-char runs, internal ' and & join, trailing +/# kept.
    CJK runs: each character is a token and each adjacent pair is a bigram
    token at the first char's position (when cjk_ngram, the default — the
    reference's CJK_NGRAM flag); with cjk_words, runs segment into
    dictionary words instead (CJK_WORDS / ICU word-break analog).
    """
    text = unicodedata.normalize("NFC", text)
    n = len(text)
    i = 0
    pos = 0
    while i < n:
        ch = text[i]
        if _is_cjk(ch):
            # consume the CJK run
            j = i
            while j < n and _is_cjk(text[j]):
                j += 1
            run = text[i:j]
            if cjk_words:
                for w in _segment_words(run.lower()):
                    yield Token(w, pos)
                    pos += 1
            elif cjk_ngram:
                for k, c in enumerate(run):
                    yield Token(c.lower(), pos)
                    if k + 1 < len(run):
                        yield Token((c + run[k + 1]).lower(), pos)
                    pos += 1
            else:
                yield Token(run.lower(), pos)
                pos += 1
            i = j
            continue
        if _is_word_char(ch):
            j = i
            buf = []
            while j < n:
                c = text[j]
                if _is_cjk(c):
                    break
                if _is_word_char(c):
                    buf.append(c)
                    j += 1
                elif c in ("'", "’", "&") and buf and j + 1 < n and \
                        _is_word_char(text[j + 1]) and not _is_cjk(text[j + 1]):
                    buf.append("'" if c != "&" else "&")
                    j += 1
                else:
                    break
            # trailing +/# (C++, C#): up to 3 '+' or one '#'
            trail = ""
            while j < n and text[j] == "+" and len(trail) < 3:
                trail += "+"
                j += 1
            if not trail and j < n and text[j] == "#":
                trail = "#"
                j += 1
            word = ("".join(buf) + trail).lower()
            yield Token(word, pos)
            pos += 1
            i = j
            continue
        i += 1


def tokenize_simple(text: str) -> list[str]:
    """Just the token strings (no positions)."""
    return [t.text for t in tokenize(text)]
