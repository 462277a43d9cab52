"""Query-string mini-language -> IR.

Reference parity target: src/booleanParser/ (hand-written lexer + recursive
descent over AND/OR/NOT/XOR/MAYBE, BooleanParser.h:36) and
src/field_parser.* (field:value, quoted literals, field:a..b ranges). This
is the `?q=` syntax compiled into the same IR as the JSON DSL
(QueryDSL::make_dsl_query analog, src/query_dsl.h:75).

Grammar:
  expr     := maybe
  maybe    := or ('MAYBE' or)*
  or       := xor ('OR' xor)*
  xor      := and ('XOR' and)*
  and      := unary (('AND')? unary)*        # adjacency = AND
  unary    := 'NOT' unary | primary
  primary  := '(' expr ')' | atom
  atom     := field ':' value | field ':' lo '..' hi | '"phrase"' | word
"""

from __future__ import annotations

import re

from xapiand_tpu_torch.query.ir import Q

_TOKEN_RE = re.compile(r"""
    (?P<lpar>\() | (?P<rpar>\)) |
    (?P<fieldquoted>[^\s()"':]+:"[^"]*"|[^\s()"':]+:'[^']*') |
    (?P<quoted>"[^"]*"|'[^']*') |
    (?P<word>[^\s()"']+)
""", re.VERBOSE)

_KEYWORDS = {"AND", "OR", "NOT", "XOR", "MAYBE"}


class BoolParserError(ValueError):
    pass


def _lex(text: str) -> list[tuple[str, str]]:
    out = []
    for m in _TOKEN_RE.finditer(text):
        kind = m.lastgroup
        tok = m.group()
        if kind == "word" and tok.upper() in _KEYWORDS and tok.isupper():
            out.append(("op", tok.upper()))
        else:
            out.append((kind, tok))
    return out


class BoolParser:
    """Parses the string syntax, delegating atoms to a QueryDSL instance."""

    def __init__(self, dsl):
        self.dsl = dsl

    def parse(self, text: str) -> Q:
        self.toks = _lex(text)
        self.pos = 0
        if not self.toks:
            return Q.match_all()
        out = self._maybe()
        if self.pos < len(self.toks):
            raise BoolParserError(
                f"unexpected token {self.toks[self.pos][1]!r}")
        return out

    def _peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else (None, None)

    def _eat(self):
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def _maybe(self):
        left = self._or()
        while self._peek() == ("op", "MAYBE"):
            self._eat()
            left = Q.and_maybe(left, self._or())
        return left

    def _or(self):
        parts = [self._xor()]
        while self._peek() == ("op", "OR"):
            self._eat()
            parts.append(self._xor())
        return parts[0] if len(parts) == 1 else Q.or_(*parts)

    def _xor(self):
        left = self._and()
        while self._peek() == ("op", "XOR"):
            self._eat()
            left = Q.xor(left, self._and())
        return left

    def _and(self):
        parts = [self._unary()]
        while True:
            kind, tok = self._peek()
            if (kind, tok) == ("op", "AND"):
                self._eat()
                kind2, tok2 = self._peek()
                if (kind2, tok2) == ("op", "NOT"):
                    self._eat()
                    right = self._unary()
                    left = parts.pop() if len(parts) == 1 else Q.and_(*parts)
                    parts = [Q.and_not(left, right)]
                    continue
                parts.append(self._unary())
            elif kind in ("lpar", "quoted", "fieldquoted", "word"):
                parts.append(self._unary())  # adjacency = AND
            else:
                break
        return parts[0] if len(parts) == 1 else Q.and_(*parts)

    def _unary(self):
        if self._peek() == ("op", "NOT"):
            self._eat()
            return Q.and_not(Q.match_all(), self._unary())
        return self._primary()

    def _primary(self):
        kind, tok = self._peek()
        if kind == "lpar":
            self._eat()
            out = self._maybe()
            if self._peek()[0] != "rpar":
                raise BoolParserError("missing ')'")
            self._eat()
            return out
        if kind == "quoted":
            self._eat()
            return self.dsl.text_phrase(tok[1:-1])
        if kind == "fieldquoted":
            self._eat()
            field, _, value = tok.partition(":")
            return self.dsl.field_query(field, {"_phrase": value[1:-1]})
        if kind == "word":
            self._eat()
            return self._atom(tok)
        raise BoolParserError(f"unexpected token {tok!r}")

    def _atom(self, tok: str) -> Q:
        if ":" in tok:
            field, _, value = tok.partition(":")
            if field and value:
                if value.startswith('"') and value.endswith('"'):
                    return self.dsl.field_query(field, {"_phrase": value[1:-1]})
                if ".." in value:
                    lo, _, hi = value.partition("..")
                    return self.dsl.field_query(field, {
                        "_from": lo if lo else None,
                        "_to": hi if hi else None})
                if value.endswith("*"):
                    return self.dsl.field_query(field,
                                                {"_wildcard": value[:-1]})
                return self.dsl.field_query(field, _coerce(value))
        if tok.endswith("*") and len(tok) > 1:
            terms = self.dsl.expand(tok[:-1].lower())
            return Q.or_terms(terms)
        return self.dsl.text_query(tok)


def _coerce(value: str):
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value
