"""Term generation: text -> (term, wdf, positions) with stemming/stopwords.

Reference parity target: Xapian::TermGenerator
(src/xapian/termgenerator.h; src/xapian/queryparser/termgenerator_internal.cc):
- STEM_SOME (default): the unstemmed lowercase term carries positions; the
  stemmed form is added as "Z"-prefixed with wdf only.
- STEM_ALL: only stemmed forms (no Z marker), with positions.
- STEM_ALL_Z: only stemmed forms, Z-prefixed, with positions.
- STEM_NONE: only unstemmed forms.
- STOP_NONE / STOP_ALL / STOP_STEMMED (default: stopwords keep their
  unstemmed term but no stemmed form is added).
- words containing digits are never stemmed.
"""

from __future__ import annotations

import re

from dataclasses import dataclass, field

from xapiand_tpu_torch.analysis.stem import Stem
from xapiand_tpu_torch.analysis.stopwords import get_stopwords
from xapiand_tpu_torch.analysis.unicode_tok import tokenize

STEM_NONE = "none"
STEM_SOME = "some"
STEM_ALL = "all"
STEM_ALL_Z = "all_z"

STOP_NONE = "none"
STOP_ALL = "all"
STOP_STEMMED = "stemmed"

MAX_TERM_LENGTH = 245  # bytes; longer words are dropped (glass key limit)


_HAS_DIGIT = re.compile(r"\d").search


def _token_pairs(text: str, cjk_ngram: bool, cjk_words: bool = False):
    """(word, position) pairs - avoids 300k+ _Tok allocations per bulk
    batch on the native path."""
    if text.isascii():
        from xapiand_tpu_torch.native import lib

        if lib is not None:
            toks = lib.tokenize_ascii(text)
            if toks is not None:
                return toks
    return [(t.text, t.position)
            for t in tokenize(text, cjk_ngram=cjk_ngram,
                              cjk_words=cjk_words)]


@dataclass
class TermEntry:
    wdf: int = 0
    positions: list[int] = field(default_factory=list)


class DocumentTerms:
    """Accumulates terms for one document (Xapian::Document term API)."""

    def __init__(self):
        self.terms: dict[str, TermEntry] = {}
        # booleans stay in a flat list until someone needs the merged dict:
        # the native bulk path ships the list in ONE ctypes call
        # (Inverter.add_bools) instead of a dict probe + add_term per term
        # (geo/date/numeric docs emit 100+ accuracy terms each)
        self.bool_terms: list[str] = []

    def add(self, term: str, wdf_inc: int = 1, position: int | None = None):
        e = self.terms.get(term)
        if e is None:
            e = self.terms[term] = TermEntry()
        e.wdf += wdf_inc
        if position is not None:
            e.positions.append(position)

    def add_boolean(self, term: str):
        """Boolean filter term: wdf 0, no position (Xapian add_boolean_term)."""
        self.bool_terms.append(term)

    def add_booleans(self, terms):
        self.bool_terms.extend(terms)

    def merge_booleans(self):
        """Fold deferred booleans into the dict (absent -> wdf-0 entry;
        present entries keep their wdf, matching add_boolean_term on an
        already-added term)."""
        if self.bool_terms:
            t = self.terms
            for term in self.bool_terms:
                if term not in t:
                    t[term] = TermEntry(wdf=0)
            self.bool_terms = []

    def __len__(self):
        self.merge_booleans()
        return len(self.terms)

    def __contains__(self, term):
        self.merge_booleans()
        return term in self.terms

    def __iter__(self):
        self.merge_booleans()
        return iter(self.terms)

    def __getitem__(self, term):
        self.merge_booleans()
        return self.terms[term]

    def items(self):
        self.merge_booleans()
        return self.terms.items()


class TermGenerator:
    def __init__(self, language: str | None = "english",
                 stem_strategy: str = STEM_SOME,
                 stop_strategy: str = STOP_STEMMED,
                 cjk_ngram: bool = True, cjk_words: bool = False):
        self.stem = Stem(language)
        self.stem_strategy = stem_strategy if self.stem.language else STEM_NONE
        self.stop_strategy = stop_strategy
        self.stopwords = get_stopwords(self.stem.language)
        self.cjk_ngram = cjk_ngram
        self.cjk_words = cjk_words
        self.position = 0  # running position across index_text calls

    def _stemmable(self, word: str) -> bool:
        return _HAS_DIGIT(word) is None

    def index_text(self, doc: DocumentTerms, text: str, wdf_inc: int = 1,
                   prefix: str = "", with_positions: bool = True,
                   prefixes: tuple | None = None) -> None:
        """Tokenise once, emit under every prefix in `prefixes` (the field
        prefix and the unprefixed global namespace share one token stream -
        one tokenise+stem pass instead of two; both namespaces see the same
        term positions)."""
        if prefixes is None:
            prefixes = (prefix,)
        base = self.position
        last_pos = -1
        add = doc.add
        stopwords = self.stopwords
        strategy = self.stem_strategy
        stop_strategy = self.stop_strategy
        stem = self.stem
        # reference key-limit semantics (schema.cc index_term): the FULL
        # emitted term - prefix + word, including the Z marker on stemmed
        # forms - must fit in 245 bytes, not just the bare word. Words of
        # <= safe_len chars cannot overflow under any prefix here even at
        # 4 UTF-8 bytes/char, so only longer (rare) words pay the encodes.
        plens = tuple(len(p.encode("utf-8")) for p in prefixes)
        safe_len = (MAX_TERM_LENGTH - max(plens) - 1) // 4
        for word, tpos in _token_pairs(text, self.cjk_ngram,
                                       self.cjk_words):
            if not word:
                continue
            if len(word) > safe_len:
                self._index_long_word(
                    doc, word, base + tpos if with_positions else None,
                    wdf_inc, prefixes, plens)
                if tpos > last_pos:
                    last_pos = tpos
                continue
            pos = base + tpos
            if tpos > last_pos:
                last_pos = tpos
            is_stop = word in stopwords
            if is_stop and stop_strategy == STOP_ALL:
                continue
            if strategy == STEM_NONE or _HAS_DIGIT(word) is not None:
                for pfx in prefixes:
                    add(pfx + word, wdf_inc,
                        pos if with_positions else None)
                continue
            if strategy == STEM_SOME:
                zstem = None
                if not (is_stop and stop_strategy == STOP_STEMMED):
                    zstem = stem(word)
                for pfx in prefixes:
                    add(pfx + word, wdf_inc,
                        pos if with_positions else None)
                    if zstem is not None:
                        add("Z" + pfx + zstem, wdf_inc, None)
            elif strategy == STEM_ALL:
                w = stem(word)
                for pfx in prefixes:
                    add(pfx + w, wdf_inc, pos if with_positions else None)
            elif strategy == STEM_ALL_Z:
                w = stem(word)
                for pfx in prefixes:
                    add("Z" + pfx + w, wdf_inc,
                        pos if with_positions else None)
        # advance running position past this block (+100 gap between fields,
        # Xapian's increase_termpos default behaviour at field boundaries)
        self.position = base + last_pos + 1

    def _index_long_word(self, doc: DocumentTerms, word: str,
                         pos: int | None, wdf_inc: int,
                         prefixes: tuple, plens: tuple) -> None:
        """Slow path for words near the 245-byte key limit: apply the same
        strategy logic as the hot loop but drop each emitted term whose
        FULL byte length (prefix [+ Z] + body) exceeds MAX_TERM_LENGTH,
        matching the reference's per-term check (schema.cc index_term)."""
        wb = len(word.encode("utf-8"))
        is_stop = word in self.stopwords
        if is_stop and self.stop_strategy == STOP_ALL:
            return
        strategy = self.stem_strategy
        if strategy == STEM_NONE or _HAS_DIGIT(word) is not None:
            for pfx, pl in zip(prefixes, plens):
                if pl + wb <= MAX_TERM_LENGTH:
                    doc.add(pfx + word, wdf_inc, pos)
            return
        if strategy == STEM_SOME:
            zstem = None
            if not (is_stop and self.stop_strategy == STOP_STEMMED):
                zstem = self.stem(word)
                zb = len(zstem.encode("utf-8"))
            for pfx, pl in zip(prefixes, plens):
                if pl + wb <= MAX_TERM_LENGTH:
                    doc.add(pfx + word, wdf_inc, pos)
                if zstem is not None and 1 + pl + zb <= MAX_TERM_LENGTH:
                    doc.add("Z" + pfx + zstem, wdf_inc, None)
            return
        w = self.stem(word)
        wb = len(w.encode("utf-8"))
        if strategy == STEM_ALL:
            for pfx, pl in zip(prefixes, plens):
                if pl + wb <= MAX_TERM_LENGTH:
                    doc.add(pfx + w, wdf_inc, pos)
        else:  # STEM_ALL_Z
            for pfx, pl in zip(prefixes, plens):
                if 1 + pl + wb <= MAX_TERM_LENGTH:
                    doc.add("Z" + pfx + w, wdf_inc, pos)

    def increase_termpos(self, delta: int = 100):
        self.position += delta

    def index_query_text(self, text: str) -> list[str]:
        """Terms a plain-text query would match against (stemmed forms under
        STEM_SOME, as the query parser generates Z-terms). If stopping would
        drop every term, the unstemmed forms are used instead - those ARE
        indexed under STEM_SOME, so an all-stopword query still matches."""
        out = []
        stopped = []
        for tok in tokenize(text, cjk_ngram=self.cjk_ngram,
                            cjk_words=self.cjk_words):
            w = tok.text
            if not w:
                continue
            if w in self.stopwords:
                stopped.append(w)
                continue
            if self.stem_strategy in (STEM_SOME, STEM_ALL_Z) and self._stemmable(w):
                out.append("Z" + self.stem(w))
            elif self.stem_strategy == STEM_ALL and self._stemmable(w):
                out.append(self.stem(w))
            else:
                out.append(w)
        if not out and stopped and self.stem_strategy in (STEM_SOME, STEM_NONE):
            return stopped
        return out
