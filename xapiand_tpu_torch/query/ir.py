"""Logical query IR: the engine-internal analog of the Xapian::Query op tree
(src/xapian/include/xapian/query.h OP_AND/OR/...).

Nodes are immutable; the plan compiler (query/plan.py) lowers them to a
static ExecConfig + dynamic plan arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class Q:
    """op in: term, or_terms, and, or, and_not, and_maybe, xor, filter,
    phrase, near, value_range, geo, match_all, match_none, scale."""

    op: str
    children: Tuple["Q", ...] = ()
    # term / or_terms / phrase / near
    terms: Tuple[str, ...] = ()
    wqf: int = 1
    factor: float = 1.0
    window: int = 0
    # value_range
    slot: Optional[int] = None
    lo_key: Optional[int] = None      # u64 sortable key, None = unbounded
    hi_key: Optional[int] = None
    cover_terms: Tuple[str, ...] = () # accuracy terms generating candidates
    # geo
    geo_ranges: Tuple[Tuple[int, int], ...] = ()

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def term(t: str, wqf: int = 1, factor: float = 1.0) -> "Q":
        return Q("term", terms=(t,), wqf=wqf, factor=factor)

    @staticmethod
    def or_terms(ts, wqf: int = 1, factor: float = 1.0) -> "Q":
        ts = tuple(ts)
        if not ts:
            return Q("match_none")
        return Q("or_terms", terms=ts, wqf=wqf, factor=factor)

    @staticmethod
    def and_(*cs) -> "Q":
        return Q("and", children=tuple(cs))

    @staticmethod
    def or_(*cs) -> "Q":
        return Q("or", children=tuple(cs))

    @staticmethod
    def and_not(a, b) -> "Q":
        return Q("and_not", children=(a, b))

    @staticmethod
    def and_maybe(a, b) -> "Q":
        return Q("and_maybe", children=(a, b))

    @staticmethod
    def xor(a, b) -> "Q":
        return Q("xor", children=(a, b))

    @staticmethod
    def filter(a, b) -> "Q":
        """a scored, b boolean-filters (OP_FILTER)."""
        return Q("filter", children=(a, b))

    @staticmethod
    def phrase(ts, window: int = 0, factor: float = 1.0) -> "Q":
        ts = tuple(ts)
        return Q("phrase", terms=ts, window=window or len(ts), factor=factor)

    @staticmethod
    def near(ts, window: int = 0, factor: float = 1.0) -> "Q":
        ts = tuple(ts)
        return Q("near", terms=ts, window=window or (len(ts) + 1),
                 factor=factor)

    @staticmethod
    def value_range(slot: int, lo_key, hi_key, cover_terms=()) -> "Q":
        return Q("value_range", slot=slot, lo_key=lo_key, hi_key=hi_key,
                 cover_terms=tuple(cover_terms))

    @staticmethod
    def geo(slot: int, ranges, cover_terms=()) -> "Q":
        return Q("geo", slot=slot, geo_ranges=tuple(ranges),
                 cover_terms=tuple(cover_terms))

    @staticmethod
    def match_all() -> "Q":
        return Q("match_all")

    @staticmethod
    def match_none() -> "Q":
        return Q("match_none")

    @staticmethod
    def scale(factor: float, child: "Q") -> "Q":
        return Q("scale", children=(child,), factor=factor)

    @staticmethod
    def max_(*cs) -> "Q":
        """OP_MAX: matches like OR but scores the max of children's
        weights instead of their sum (xapian/matcher/maxpostlist.h)."""
        return Q("max", children=tuple(cs))

    @staticmethod
    def synonym(ts, wqf: int = 1, factor: float = 1.0) -> "Q":
        """OP_SYNONYM: children act as one term - wdf summed per doc,
        weighted once (xapian/matcher/synonympostlist.h)."""
        ts = tuple(ts)
        if not ts:
            return Q("match_none")
        return Q("synonym", terms=ts, wqf=wqf, factor=factor)

    @staticmethod
    def elite_set(cs, n: int = 10) -> "Q":
        """OP_ELITE_SET: keep only the n highest-impact subqueries, then
        act as OR (docs compound-queries/elite-set-operator.md). Resolution
        happens against collection stats (resolve_special in query/plan.py);
        unresolved nodes compile as plain OR."""
        return Q("elite_set", children=tuple(cs), window=n)

    def signature(self) -> str:
        """Structural signature (shape of the compiled program, ignoring
        which concrete terms/values are used) - part of the jit cache key."""
        if self.op in ("term", "or_terms"):
            return "T"
        if self.op == "synonym":
            return "SYN"
        if self.op in ("phrase", "near"):
            return f"{self.op}{len(self.terms)}w{self.window}"
        if self.op == "value_range":
            return f"VR{'c' if self.cover_terms else ''}"
        if self.op == "geo":
            return "GEO"
        inner = ",".join(c.signature() for c in self.children)
        return f"{self.op}({inner})"
