"""Ranking weight schemes, jax-free (counterpart of
``xapiand_tpu/models/weights.py``: BM25 and the other 15 schemes, LM with
its five smoothings).

Host-side per-term constants (``term_constant``) are the same Python
float64 arithmetic as the JAX package, so bound plans carry bit-identical
``tconst`` arrays ([T], or [T, n_constants] for the two-constant schemes).

The per-posting formula (``sumpart``) is float32 device arithmetic. Each
scheme reduces it to a ``SchemeSpec``: a small scheme id and a float32
parameter vector (``kernel_spec(stats)``), holding the scheme's own
parameters and the collection statistics its formula reads, with every
constant folded as the JAX expressions fold it: Python evaluates
sub-expressions such as ``2.0 * math.pi`` or ``delta / (k1 + 1.0)`` in
float64 before they meet a float32 array, and a product of two float32
statistics (``avg_doclen * N``) is one float32 rounding. Everything else is
evaluated per posting, in JAX's operation order, by ``scheme_sumpart`` on
torch tensors here and by ``scheme_sumpart`` in ``csrc/common.cuh`` in the
kernels; the two round after every operation in the same order, so the
kernels equal this plain version bit for bit.

Divisions in the plain version take a tensor divisor: PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal (and ``c / t``
is ``t.reciprocal() * c``), which would round differently from the
kernels' IEEE division.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

_LN2 = math.log(2.0)
_LOG2_2PI = math.log2(2.0 * math.pi)

# scheme ids of the kernels (csrc/common.cuh XT_SCHEME_*), one per
# per-posting formula: IneB2 shares IfB2's, LM has one per smoothing
(S_BM25, S_BM25PLUS, S_TFIDF, S_TRAD, S_BOOL, S_COORD, S_DICE, S_INL2,
 S_IFB2, S_BB2, S_PL2, S_PL2PLUS, S_DLH, S_DPH, S_LM_TWO_STAGE, S_LM_JM,
 S_LM_DIRICHLET, S_LM_DIRICHLET_PLUS, S_LM_ABS) = range(19)
SCHEME_PARAMS = 8          # floats of a SchemeSpec (csrc/common.cuh)
UNIQ_SCHEMES = (S_DICE, S_LM_ABS)


@dataclass(frozen=True)
class CollectionStats:
    doc_count: int          # N
    avg_doclen: float       # collection average document length
    doclen_lower: float = 1.0
    doclen_upper: float = 1.0
    total_len: float = 0.0  # total term occurrences (sum of doclens)
    query_length: int = 1   # sum of wqf over the query's terms


@dataclass(frozen=True)
class SchemeSpec:
    """What the kernels take for a scheme: ``sid`` (one of S_*) and
    ``params``, float32 values (as Python floats), at most SCHEME_PARAMS."""
    sid: int
    params: tuple = ()

    @property
    def needs_uniq(self) -> bool:
        return self.sid in UNIQ_SCHEMES


def _f32(x) -> float:
    return float(np.float32(x))


def _mul32(a, b) -> float:
    """One float32 product of two float32 values."""
    return float(np.float32(a) * np.float32(b))


class WeightScheme:
    """Base: subclasses define term_constant() and kernel_spec()."""

    name = "base"
    n_constants = 1          # floats returned by term_constant()
    needs_uniqterms = False  # sumpart() wants per-doc distinct-term counts

    def impact_np(self, wdf, doclen, stats: CollectionStats):
        """Numpy per-posting impact g for schemes whose sumpart factorises
        as tconst * g; None: not separable, no impact-prefix mode."""
        return None

    def term_constant(self, stats: CollectionStats, termfreq: int,
                      wqf: int = 1, factor: float = 1.0, collfreq: int = 0):
        """Host-side per-term constant(s) (the reference's Weight::init)."""
        raise NotImplementedError

    def kernel_spec(self, stats: CollectionStats) -> SchemeSpec:
        raise NotImplementedError

    def sumpart(self, wdf, doclen, tconst, stats: CollectionStats,
                uniq=None):
        """The per-posting weight on float32 tensors. tconst is a scalar or
        a tensor broadcastable to wdf when n_constants == 1, else indexable
        as tconst[0], tconst[1] (a [2] vector, or [2, L] per posting)."""
        wdf = torch.as_tensor(wdf, dtype=torch.float32)
        dev = wdf.device

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        tc = (t(tconst),) if self.n_constants == 1 else \
            (t(tconst[0]), t(tconst[1]))
        return scheme_sumpart(self.kernel_spec(stats), wdf, t(doclen), tc,
                              None if uniq is None else t(uniq))

    def max_sumpart(self, tconst, max_wdf: float,
                    stats: CollectionStats) -> float:
        """Upper bound (block-max pruning analog, bm25weight.cc:184)."""
        t = tconst[0] if hasattr(tconst, "__len__") else tconst
        return abs(t) * 1e9

    def key(self) -> str:
        return self.name


def _cavg(c, stats) -> float:
    """c * avg_doclen of the DFR normalisation 2, one float32 rounding."""
    return _mul32(c, stats.avg_doclen)


def _n32(stats) -> float:
    return _f32(stats.doc_count)


class BM25(WeightScheme):
    """Xapian::BM25Weight (bm25weight.cc). Defaults k1=1, k2=0, k3=1, b=0.5,
    min_normlen=0.5."""

    name = "bm25"

    def __init__(self, k1: float = 1.0, k2: float = 0.0, k3: float = 1.0,
                 b: float = 0.5, min_normlen: float = 0.5):
        self.k1, self.k2, self.k3, self.b = k1, k2, k3, b
        self.min_normlen = min_normlen

    def key(self):
        return f"bm25:{self.k1}:{self.k2}:{self.k3}:{self.b}:{self.min_normlen}"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        # bm25weight.cc:49-90 (no rset path)
        n = max(int(termfreq), 0)
        tw = (stats.doc_count - n + 0.5) / (n + 0.5)
        if tw < 2.0:
            tw = tw * 0.5 + 1.0
        termweight = math.log(tw) * factor
        if self.k3 != 0:
            termweight *= (self.k3 + 1.0) * wqf / (self.k3 + wqf)
        termweight *= (self.k1 + 1.0)
        return termweight

    def _len_factor(self, stats) -> float:
        """1/avg_doclen rounded as float32 arithmetic rounds it (the JAX
        package computes it in float32 from a float32 avg_doclen)."""
        if self.k2 == 0 and (self.b == 0 or self.k1 == 0):
            return 0.0
        avg = np.float32(stats.avg_doclen)
        if not avg > 0:
            return 0.0
        return float(np.float32(1.0) / max(avg, np.float32(1e-9)))

    def kernel_spec(self, stats):
        # (lf, k1, b, 1-b, min_normlen)
        return SchemeSpec(S_BM25, (self._len_factor(stats), _f32(self.k1),
                                   _f32(self.b), _f32(1.0 - self.b),
                                   _f32(self.min_normlen)))

    def impact_np(self, wdf, doclen, stats):
        # sumpart == tconst * g: the same formula, host-side numpy
        avg = float(stats.avg_doclen)
        lf = (1.0 / max(avg, 1e-9)) if (avg > 0 and not (
            self.k2 == 0 and (self.b == 0 or self.k1 == 0))) else 0.0
        normlen = np.maximum(doclen * lf, self.min_normlen)
        denom = self.k1 * (normlen * self.b + (1.0 - self.b)) + wdf
        return (wdf / np.maximum(denom, 1e-9)).astype(np.float32)

    def max_sumpart(self, tconst, max_wdf, stats):
        lf = self._len_factor(stats)
        normlen_lb = max(max(max_wdf, stats.doclen_lower) * lf,
                         self.min_normlen)
        denom = self.k1
        if self.k1 != 0 and self.b != 0:
            denom *= normlen_lb * self.b + (1 - self.b)
        denom += max_wdf
        return tconst * (max_wdf / denom) if denom > 0 else 0.0


class BM25Plus(BM25):
    """Xapian::BM25PlusWeight (bm25plusweight.cc): BM25 + delta lower bound.
    Its impact order is BM25's (impact_np inherited)."""

    name = "bm25plus"

    def __init__(self, k1: float = 1.0, k2: float = 0.0, k3: float = 1.0,
                 b: float = 0.5, min_normlen: float = 0.5,
                 delta: float = 1.0):
        super().__init__(k1, k2, k3, b, min_normlen)
        self.delta = delta

    def key(self):
        return super().key() + f":+{self.delta}"

    def kernel_spec(self, stats):
        # BM25's five, then delta / (k1 + 1) folded in float64
        return SchemeSpec(S_BM25PLUS, super().kernel_spec(stats).params + (
            _f32(self.delta / (self.k1 + 1.0)),))

    def max_sumpart(self, tconst, max_wdf, stats):
        return super().max_sumpart(tconst, max_wdf, stats) + \
            abs(tconst) * self.delta / (self.k1 + 1.0)


class TfIdf(WeightScheme):
    """Xapian::TfIdfWeight, default normalizations "ntn"
    (tfidfweight.cc: wdf * log(N/termfreq))."""

    name = "tfidf"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        n = max(int(termfreq), 1)
        return math.log(stats.doc_count / n) * factor * wqf

    def kernel_spec(self, stats):
        return SchemeSpec(S_TFIDF)

    def max_sumpart(self, tconst, max_wdf, stats):
        return tconst * max_wdf


class Trad(WeightScheme):
    """Xapian::TradWeight (tradweight.cc): k * wdf / (k*normlen + wdf) * idf."""

    name = "trad"

    def __init__(self, k: float = 1.0):
        self.k = k

    def key(self):
        return f"trad:{self.k}"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        n = max(int(termfreq), 0)
        tw = (stats.doc_count - n + 0.5) / (n + 0.5)
        if tw < 2.0:
            tw = tw * 0.5 + 1.0
        return math.log(tw) * factor

    def kernel_spec(self, stats):
        # (k, max(avg_doclen, 1e-9)); k == 0 scores tconst
        avg = np.float32(stats.avg_doclen)
        return SchemeSpec(S_TRAD, (_f32(self.k),
                                   float(max(avg, np.float32(1e-9)))))


class Bool(WeightScheme):
    """Xapian::BoolWeight: all weights zero."""

    name = "bool"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        return 0.0

    def kernel_spec(self, stats):
        return SchemeSpec(S_BOOL)

    def max_sumpart(self, tconst, max_wdf, stats):
        return 0.0


class Coord(WeightScheme):
    """Xapian::CoordWeight: 1 per matching term."""

    name = "coord"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        return factor

    def kernel_spec(self, stats):
        return SchemeSpec(S_COORD)

    def max_sumpart(self, tconst, max_wdf, stats):
        return tconst


class DiceCoeff(WeightScheme):
    """Xapian::DiceCoeffWeight (dicecoeffweight.cc):
    2 * wqf / (query_length + uniqterms(doc))."""

    name = "dicecoeff"
    needs_uniqterms = True

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        return wqf * factor

    def kernel_spec(self, stats):
        return SchemeSpec(S_DICE, (_f32(stats.query_length),))

    def max_sumpart(self, tconst, max_wdf, stats):
        return tconst * 2.0 / (1.0 + 1.0)


# ---------------------------------------------------------------------------
# DFR (Divergence From Randomness) family
# ---------------------------------------------------------------------------

class InL2(WeightScheme):
    """Xapian::InL2Weight (inl2weight.cc): I(n)L2 —
    idf = log2((N+1)/(n+0.5)); w = idf * wdfn/(wdfn+1)."""

    name = "inl2"

    def __init__(self, c: float = 1.0):
        if c <= 0:
            raise ValueError("Parameter c is invalid.")
        self.c = c

    def key(self):
        return f"{self.name}:{self.c}"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        n = max(int(termfreq), 0)
        idf = math.log2((stats.doc_count + 1.0) / (n + 0.5))
        return wqf * factor * idf

    def kernel_spec(self, stats):
        return SchemeSpec(S_INL2, (_cavg(self.c, stats),))

    def max_sumpart(self, tconst, max_wdf, stats):
        wu = max_wdf * math.log2(
            1.0 + self.c * stats.avg_doclen / max(stats.doclen_lower, 1.0))
        return tconst * wu / (wu + 1.0) if wu > 0 else 0.0


class IfB2(WeightScheme):
    """Xapian::IfB2Weight (ifb2weight.cc): I(F)B2 —
    idf = log2((N+1)/(F+0.5)); B = (F+1)/(n*(wdfn+1)); w = idf * wdfn * B."""

    name = "ifb2"
    n_constants = 2

    def __init__(self, c: float = 1.0):
        if c <= 0:
            raise ValueError("Parameter c is invalid.")
        self.c = c

    def key(self):
        return f"{self.name}:{self.c}"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        n = max(int(termfreq), 1)
        F = max(int(collfreq), 1)
        idf = math.log2((stats.doc_count + 1.0) / (F + 0.5))
        return (wqf * factor * idf, (F + 1.0) / n)

    def kernel_spec(self, stats):
        return SchemeSpec(S_IFB2, (_cavg(self.c, stats),))

    def max_sumpart(self, tconst, max_wdf, stats):
        wu = max_wdf * math.log2(
            1.0 + self.c * stats.avg_doclen / max(stats.doclen_lower, 1.0))
        return tconst[0] * wu * tconst[1] / (wu + 1.0) if wu > 0 else 0.0


class IneB2(IfB2):
    """Xapian::IneB2Weight (ineb2weight.cc): I(n_e)B2 — idf uses the
    expected number of documents containing the term, ne = N*(1-e^{-F/N})."""

    name = "ineb2"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        n = max(int(termfreq), 1)
        F = max(int(collfreq), 1)
        N = max(stats.doc_count, 1)
        mean = F / N
        expected = N * (1.0 - math.exp(-mean))
        idf = math.log2((N + 1.0) / (expected + 0.5))
        return (wqf * factor * idf, (F + 1.0) / n)


class BB2(WeightScheme):
    """Xapian::BB2Weight (bb2weight.cc): Bose-Einstein stats with Stirling
    approximation; B2 first normalization. Mirrored as the JAX package
    writes it, cancellation included (ROADMAP queue 3)."""

    name = "bb2"
    n_constants = 2

    def __init__(self, c: float = 1.0):
        if c <= 0:
            raise ValueError("Parameter c is invalid.")
        self.c = c

    def key(self):
        return f"{self.name}:{self.c}"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        n = max(int(termfreq), 1)
        F = max(int(collfreq), 1)
        return (wqf * factor * (F + 1.0) / n, float(F))

    def kernel_spec(self, stats):
        # (c*avg, max(N, 2), -1/ln 2)
        return SchemeSpec(S_BB2, (_cavg(self.c, stats),
                                  max(_n32(stats), 2.0), _f32(-1.0 / _LN2)))


class PL2(WeightScheme):
    """Xapian::PL2Weight (pl2weight.cc): Poisson + Laplace + normalization 2.
    P = P1 + (wdfn+0.5)*log2(wdfn) - P2*wdfn; w = P/(wdfn+1)."""

    name = "pl2"
    n_constants = 2

    def __init__(self, c: float = 1.0):
        if c <= 0:
            raise ValueError("Parameter c is invalid.")
        self.c = c

    def key(self):
        return f"{self.name}:{self.c}"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        F = max(int(collfreq), 1)
        return (wqf * factor, float(F))

    def kernel_spec(self, stats):
        # (c*avg, max(N, 1), ln 2, 0.5*log2(2 pi), 1/ln 2)
        return SchemeSpec(S_PL2, (_cavg(self.c, stats),
                                  max(_n32(stats), 1.0), _f32(_LN2),
                                  _f32(0.5 * _LOG2_2PI), _f32(1.0 / _LN2)))


class PL2Plus(PL2):
    """Xapian::PL2PlusWeight (pl2plusweight.cc): PL2 + delta lower-bound
    correction; zero unless collection mean F/N >= 1."""

    name = "pl2plus"

    def __init__(self, c: float = 1.0, delta: float = 0.8):
        super().__init__(c)
        if delta <= 0:
            raise ValueError("Parameter delta is invalid.")
        self.delta = delta

    def key(self):
        return f"{self.name}:{self.c}:{self.delta}"

    def kernel_spec(self, stats):
        # PL2's five, then delta and delta + 1 (folded in float64)
        return SchemeSpec(S_PL2PLUS, super().kernel_spec(stats).params + (
            _f32(self.delta), _f32(self.delta + 1.0)))


class DLH(WeightScheme):
    """Xapian::DLHWeight (dlhweight.cc) — parameter-free DFR hypergeometric.

    wt = (wdf*log2(f * avg*N/F) + (len-wdf)*log2(1-f)
          + 0.5*log2(2*pi*wdf*(1-f))) / (wdf + 0.5), f = wdf/len.
    """

    name = "dlh"
    n_constants = 2

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        F = max(int(collfreq), 1)
        return (wqf * factor, float(F))

    def kernel_spec(self, stats):
        # (avg * N, 2 pi)
        return SchemeSpec(S_DLH, (_mul32(stats.avg_doclen, stats.doc_count),
                                  _f32(2.0 * math.pi)))


class DPH(WeightScheme):
    """Xapian::DPHWeight (dphweight.cc) — parameter-free DFR.

    norm = (1-f)^2/(wdf+1);
    wt = norm * (wdf*log2(f * avg*N/F) + 0.5*log2(2*pi*wdf*(1-f))).
    """

    name = "dph"
    n_constants = 2

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        F = max(int(collfreq), 1)
        return (wqf * factor, float(F))

    def kernel_spec(self, stats):
        return SchemeSpec(S_DPH, DLH.kernel_spec(self, stats).params)


class LM(WeightScheme):
    """Xapian::LMWeight (lmweight.cc): unigram language model with smoothing.

    smoothing in {"two_stage" (default), "jelinek_mercer", "dirichlet",
    "dirichlet_plus", "absolute_discount"}; defaults param_log=0 (-> doclen
    upper bound), s1=0.7, s2=2000. weight_collection = F / total collection
    length; score = log(weight_sum * param_log) when > 0.
    """

    name = "lm"
    n_constants = 2

    SMOOTHINGS = ("two_stage", "jelinek_mercer", "dirichlet",
                  "dirichlet_plus", "absolute_discount")
    _SIDS = dict(zip(SMOOTHINGS, (S_LM_TWO_STAGE, S_LM_JM, S_LM_DIRICHLET,
                                  S_LM_DIRICHLET_PLUS, S_LM_ABS)))

    def __init__(self, param_log: float = 0.0, smoothing: str = "two_stage",
                 s1: float = 0.7, s2: float = 2000.0):
        if smoothing not in self.SMOOTHINGS:
            raise ValueError(f"unknown LM smoothing {smoothing!r}")
        self.param_log = param_log
        self.smoothing = smoothing
        self.s1, self.s2 = s1, s2

    @property
    def needs_uniqterms(self):
        return self.smoothing == "absolute_discount"

    def key(self):
        return f"lm:{self.param_log}:{self.smoothing}:{self.s1}:{self.s2}"

    def term_constant(self, stats, termfreq, wqf=1, factor=1.0, collfreq=0):
        F = max(int(collfreq), 1)
        total = max(stats.total_len, 1.0)
        return (factor, F / total)   # (factor, weight_collection)

    def kernel_spec(self, stats):
        # (s1, s2, 1 - s1, param_log or doclen_upper)
        pl = self.param_log if self.param_log > 0 else stats.doclen_upper
        return SchemeSpec(self._SIDS[self.smoothing],
                          (_f32(self.s1), _f32(self.s2), _f32(1.0 - self.s1),
                           _f32(pl)))


_SCHEMES = {
    "bm25": BM25, "bm25plus": BM25Plus, "tfidf": TfIdf, "trad": Trad,
    "bool": Bool, "coord": Coord, "dicecoeff": DiceCoeff,
    "inl2": InL2, "ifb2": IfB2, "ineb2": IneB2, "bb2": BB2,
    "pl2": PL2, "pl2plus": PL2Plus, "dlh": DLH, "dph": DPH, "lm": LM,
}


def get_scheme(name: str = "bm25", **params) -> WeightScheme:
    cls = _SCHEMES.get(name.lower())
    if cls is None:
        raise ValueError(f"unknown weight scheme {name!r}")
    return cls(**params)


# ---------------------------------------------------------------------------
# the per-posting formulas on float32 tensors (the kernels' plain version)
# ---------------------------------------------------------------------------

def bm25_sumpart(wdf, doclen, tconst, params):
    """BM25 per-posting weight, one rounding per op in the JAX package's
    order; params = the five of BM25.kernel_spec."""
    lf, k1, b, omb, mnl = params[:5]
    normlen = torch.clamp_min(doclen * lf, mnl)
    denom = k1 * (normlen * b + omb) + wdf
    return tconst * (wdf / torch.clamp_min(denom, 1e-9))


def _wdfn(wdf, doclen, cavg):
    """DFR "normalization 2": wdf * log2(1 + c*avg / max(len, 1))."""
    return wdf * torch.log2(1.0 + _c(wdf, cavg) / torch.clamp_min(doclen, 1.0))


def _c(like, v):
    """v as a 0-dim float32 tensor on like's device (a divisor or dividend
    beside a tensor: see the module docstring)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _pl2_p(wdfn, F, p):
    """PL2's P(wdfn) for collection frequency F (weights.py PL2._P)."""
    _cavg_, n1, ln2, p1c, iln2 = p[:5]
    mean = F / _c(F, n1)
    P1 = mean / _c(F, ln2) + p1c
    P2 = torch.log2(mean) + iln2
    return P1 + (wdfn + 0.5) * torch.log2(torch.clamp_min(wdfn, 1e-9)) \
        - P2 * wdfn


def _stirling(difference, y, constant):
    # stirling_value(d, y, c) = (y+0.5)*(c - log2 y) + d*c
    return (y + 0.5) * (constant - torch.log2(torch.clamp_min(y, 1e-9))) \
        + difference * constant


def _dfr_f(wdf, doclen, F, p):
    """DLH / DPH's common terms: (len, 1-f, max(wdf, 1e-9), the first
    log2 argument f * avg*N/F clamped)."""
    avg_n = p[0]
    log_const = _c(F, avg_n) / F
    dl = torch.clamp_min(doclen, 1.0)
    f = wdf / dl
    omf = torch.clamp(1.0 - f, 1e-9, 1.0)
    wdfs = torch.clamp_min(wdf, 1e-9)
    return dl, omf, wdfs, torch.clamp_min(f * log_const, 1e-30)


def scheme_sumpart(spec: SchemeSpec, wdf, doclen, tc, uniq=None):
    """The per-posting weight of ``spec`` on float32 tensors: wdf, doclen
    and every tc[i] (the term's constants, len(tc) = n_constants) and uniq
    (the doc's distinct terms, None: 1) broadcast together. The formulas
    of xapiand_tpu/models/weights.py, operation for operation."""
    sid, p = spec.sid, spec.params
    tc0 = tc[0]
    if sid == S_BM25:
        return bm25_sumpart(wdf, doclen, tc0, p)
    zero = 0.0
    if sid == S_BM25PLUS:
        lf, k1, b, omb, mnl, dk = p
        normlen = torch.clamp_min(doclen * lf, mnl)
        denom = k1 * (normlen * b + omb) + wdf
        part = wdf / torch.clamp_min(denom, 1e-9) + dk
        return torch.where(wdf > 0, tc0 * part, zero)
    if sid == S_TFIDF:
        return tc0 * wdf
    if sid == S_TRAD:
        k, avgc = p
        if k == 0:
            return tc0 * torch.ones_like(wdf)
        normlen = doclen / _c(doclen, avgc)
        denom = k * normlen + wdf
        return tc0 * (wdf / torch.clamp_min(denom, 1e-9))
    if sid == S_BOOL:
        return torch.zeros_like(wdf)
    if sid == S_COORD:
        return tc0 * torch.ones_like(wdf)
    if sid == S_DICE:
        u = uniq if uniq is not None else torch.ones_like(wdf)
        return torch.where(wdf > 0, tc0 * 2.0 / (p[0] + u), zero)
    if sid == S_INL2:
        wdfn = _wdfn(wdf, doclen, p[0])
        return torch.where(wdf > 0, tc0 * wdfn / (wdfn + 1.0), zero)
    if sid == S_IFB2:
        wdfn = _wdfn(wdf, doclen, p[0])
        w = tc0 * wdfn * tc[1] / (wdfn + 1.0)
        return torch.where(wdf > 0, w, zero)
    if sid == S_BB2:
        cavg, n2, m1ln2 = p
        F = tc[1]
        wdfn = torch.minimum(_wdfn(wdf, doclen, cavg), F - 1.0)
        N = _c(wdf, n2)
        wt = m1ln2 - torch.log2(N - 1.0)
        sc1 = torch.log2(N + F - 1.0)
        sc2 = torch.log2(F)
        y2 = F - wdfn
        y1 = (N - 2.0) + y2
        stirling = _stirling(wdfn + 1.0, y1, sc1) - _stirling(wdfn, y2, sc2)
        w = tc0 / (wdfn + 1.0) * (wt + stirling)
        return torch.where((wdf > 0) & (w > 0), w, zero)
    if sid == S_PL2:
        wdfn = _wdfn(wdf, doclen, p[0])
        P = _pl2_p(wdfn, tc[1], p)
        w = tc0 * P / (wdfn + 1.0)
        return torch.where((wdf > 0) & (P > 0), w, zero)
    if sid == S_PL2PLUS:
        F = tc[1]
        delta, dp1 = p[5], p[6]
        mean = F / _c(F, p[1])
        wdfn = _wdfn(wdf, doclen, p[0])
        P = _pl2_p(wdfn, F, p)
        dw = _pl2_p(torch.full_like(wdfn, delta), F, p) / _c(F, dp1)
        wt = P / (wdfn + 1.0) + dw
        w = tc0 * wt
        return torch.where((wdf > 0) & (mean >= 1.0) & (wt > 0), w, zero)
    if sid in (S_DLH, S_DPH):
        dl, omf, wdfs, arg = _dfr_f(wdf, doclen, tc[1], p)
        twopi = p[1]
        if sid == S_DLH:
            wt = wdf * torch.log2(arg) + (dl - wdf) * torch.log2(omf) \
                + 0.5 * torch.log2(twopi * wdfs * omf)
            w = tc0 * wt / (wdfs + 0.5)
        else:
            norm = omf * omf / (wdf + 1.0)
            wt = norm * (wdf * torch.log2(arg)
                         + 0.5 * torch.log2(twopi * wdfs * omf))
            w = tc0 * wt
        return torch.where((wdf > 0) & (wdf < dl) & (wt > 0), w, zero)
    if sid in (S_LM_TWO_STAGE, S_LM_JM, S_LM_DIRICHLET, S_LM_DIRICHLET_PLUS,
               S_LM_ABS):
        s1, s2, oms1, pl = p
        wc = tc[1]
        ln = torch.clamp_min(doclen, 1.0)
        if sid == S_LM_JM:
            ws = s1 * wc + oms1 * wdf / ln
        elif sid == S_LM_DIRICHLET:
            ws = (wdf + s1 * wc) / (ln + s1)
        elif sid == S_LM_DIRICHLET_PLUS:
            sw = s1 * wc
            ws = (1.0 + wdf / sw) * (1.0 + _c(sw, s2) / sw)
        elif sid == S_LM_ABS:
            u = uniq if uniq is not None else torch.ones_like(wdf)
            ws = torch.clamp_min(wdf - s1, 0.0) / ln + (s1 * wc * u) / ln
        else:   # two_stage
            ws = oms1 * (wdf + s2 * wc) / (ln + s2) + s1 * wc
        product = ws * pl
        return torch.where((wdf > 0) & (product > 1.0),
                           tc0 * torch.log(torch.clamp_min(product, 1.0)),
                           zero)
    raise ValueError(f"unknown scheme id {sid}")
