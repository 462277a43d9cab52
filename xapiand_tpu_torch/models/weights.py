"""Ranking weight schemes, jax-free (counterpart of
``xapiand_tpu/models/weights.py:39-161``).

Host-side per-term constants are the same Python arithmetic as the JAX
package, so bound plans carry bit-identical ``tconst`` arrays. The
per-posting formula (``sumpart``) runs on torch tensors here; the CUDA
kernels evaluate the same expression in the same float32 operation order
(``csrc/common.cuh`` ``bm25_sumpart``) from the constants of
``BM25.kernel_params``.

Only BM25 is ported. The other 15 schemes are ROADMAP queue 2 item K18.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class CollectionStats:
    doc_count: int          # N
    avg_doclen: float       # collection average document length
    doclen_lower: float = 1.0
    doclen_upper: float = 1.0
    total_len: float = 0.0  # total term occurrences (sum of doclens)
    query_length: int = 1   # sum of wqf over the query's terms


class WeightScheme:
    """Base: subclasses define term_constant() and sumpart()."""

    name = "base"
    n_constants = 1          # floats returned by term_constant()
    needs_uniqterms = False  # sumpart() wants per-doc distinct-term counts

    def impact_np(self, wdf, doclen, stats: CollectionStats):
        return None

    def term_constant(self, stats: CollectionStats, termfreq: int,
                      wqf: int = 1, factor: float = 1.0, collfreq: int = 0):
        raise NotImplementedError

    def sumpart(self, wdf, doclen, tconst, stats: CollectionStats,
                uniq=None):
        raise NotImplementedError

    def key(self) -> str:
        return self.name


def _f32(x) -> float:
    return float(np.float32(x))


def bm25_sumpart(wdf, doclen, tconst, params):
    """BM25 per-posting weight on float32 tensors, one rounding per op in
    the JAX package's order; params = BM25.kernel_params(stats)."""
    lf, k1, b, omb, mnl = params
    normlen = torch.clamp_min(doclen * lf, mnl)
    denom = k1 * (normlen * b + omb) + wdf
    return tconst * (wdf / torch.clamp_min(denom, 1e-9))


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

    def kernel_params(self, stats) -> tuple:
        """(lf, k1, b, 1-b, min_normlen) as float32 values: the constants
        of ``sumpart``, in the form the CUDA kernels take them."""
        return (self._len_factor(stats), _f32(self.k1), _f32(self.b),
                _f32(1.0 - self.b), _f32(self.min_normlen))

    def sumpart(self, wdf, doclen, tconst, stats, uniq=None):
        # bm25weight.cc:171-181
        return bm25_sumpart(wdf, doclen, tconst, self.kernel_params(stats))

    def impact_np(self, wdf, doclen, stats):
        # sumpart == tconst * g: the same formula, host-side numpy
        avg = float(stats.avg_doclen)
        lf = (1.0 / max(avg, 1e-9)) if (avg > 0 and not (
            self.k2 == 0 and (self.b == 0 or self.k1 == 0))) else 0.0
        normlen = np.maximum(doclen * lf, self.min_normlen)
        denom = self.k1 * (normlen * self.b + (1.0 - self.b)) + wdf
        return (wdf / np.maximum(denom, 1e-9)).astype(np.float32)


def get_scheme(name: str = "bm25", **params) -> WeightScheme:
    if name.lower() == "bm25":
        return BM25(**params)
    raise NotImplementedError(
        f"weight scheme {name!r} is not ported yet (ROADMAP queue 2, K18)")
