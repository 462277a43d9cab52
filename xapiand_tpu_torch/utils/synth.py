"""Synthetic corpus generation: fast numpy path straight to Segment arrays.

Used by bench.py and the graft entry: builds a Zipf-distributed term corpus
without running the per-document analysis chain, so benchmarks measure the
device query engine, not Python tokenisation (indexing throughput is
benchmarked separately through the REST bulk path).
"""

from __future__ import annotations

import numpy as np

from xapiand_tpu_torch.models.segment import Segment, TermInfo, size_class


def build_synthetic_segment(n_docs: int, vocab: int = 50_000,
                            min_len: int = 30, max_len: int = 100,
                            seed: int = 0) -> Segment:
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, n_docs)
    total = int(lens.sum())
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    # Zipf-ish term draw, clipped to vocab
    raw = rng.zipf(1.3, total)
    tids = ((raw - 1) % vocab).astype(np.int64)

    # accumulate wdf per (term, doc)
    key = tids * n_docs + doc_of
    uniq, counts = np.unique(key, return_counts=True)
    u_tid = (uniq // n_docs).astype(np.int64)
    u_doc = (uniq % n_docs).astype(np.int32)
    # np.unique sorts keys -> already grouped by term, docid-ascending
    term_ids, term_starts = np.unique(u_tid, return_index=True)
    term_lens = np.diff(np.append(term_starts, len(u_tid)))

    max_len_term = int(term_lens.max())
    guard = size_class(max_len_term)
    P = len(u_tid) + guard
    post_docids = np.full(P, n_docs, dtype=np.int32)
    post_docids[: len(u_doc)] = u_doc
    post_wdf = np.zeros(P, dtype=np.float32)
    post_wdf[: len(u_doc)] = counts.astype(np.float32)

    doclen = np.zeros(n_docs + 1, dtype=np.float32)
    doclen[:n_docs] = np.bincount(doc_of, minlength=n_docs).astype(np.float32)
    post_doclen = doclen[np.minimum(post_docids, n_docs)]

    terms = {}
    for tid, off, ln in zip(term_ids, term_starts, term_lens):
        terms[f"t{tid}"] = TermInfo(tid=int(tid), offset=int(off),
                                    length=int(ln), collfreq=int(ln),
                                    max_wdf=0.0)

    return Segment(
        num_docs=n_docs,
        total_doclen=float(doclen.sum()),
        post_docids=post_docids,
        post_wdf=post_wdf,
        post_doclen=post_doclen,
        post_posoff=np.zeros(1, dtype=np.int32),
        post_poslen=np.zeros(1, dtype=np.int32),
        positions=np.zeros(128, dtype=np.int32),
        doclen=doclen,
        deleted=np.zeros(n_docs + 1, dtype=bool),
        terms=terms,
        values={},
        geo={},
        doc_keys=[str(i) for i in range(n_docs)],
        guard=guard,
    )


def sample_queries(seg: Segment, n_queries: int, terms_per_query: int = 3,
                   seed: int = 1, max_df_frac: float = 0.1) -> list[list[str]]:
    """Query term lists drawn from the corpus vocabulary, biased to
    mid-frequency terms (like real query logs, and keeps posting gathers
    in one size class)."""
    rng = np.random.default_rng(seed)
    cap = max(int(seg.num_docs * max_df_frac), 10)
    names = [t for t, ti in seg.terms.items() if 2 <= ti.length <= cap]
    names.sort(key=lambda t: -seg.terms[t].length)
    pool = names[: max(2000, len(names) // 10)]
    out = []
    for _ in range(n_queries):
        k = terms_per_query
        idx = rng.choice(len(pool), size=k, replace=False)
        out.append([pool[i] for i in idx])
    return out
