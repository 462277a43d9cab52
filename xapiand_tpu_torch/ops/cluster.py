"""MSet document clustering and result diversification: the torch port
of ``xapiand_tpu/ops/cluster.py``.

Reference parity targets: src/xapian/cluster/ (TF-IDF document vectors +
cosine similarity, K-means over an MSet) and src/xapian/diversify/
(GLS/MPT-style result diversification). ``tfidf_vectors`` and
``diversify_mmr`` are numpy, the JAX file's text. ``kmeans_cosine`` keeps
the JAX farthest-first seeding in numpy on the host, line for line, so
both packages start from the same centroids on the same X; its 20 steps
and last assignment run in one launch of the K20 kernel
(``kernels.kmeans_loop``, ``csrc/kmeans.cu``) on the card, or its plain
version on CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np


def tfidf_vectors(term_lists: list[dict], doc_count: int,
                  df: dict, max_vocab: int = 2048):
    """term_lists: per doc {term: wdf}; df: term -> document frequency.

    Returns (X [n, V] float32 L2-normalised, vocab list)."""
    seen: dict[str, float] = {}
    for terms in term_lists:
        for t in terms:
            if t not in seen:
                n = max(df.get(t, 1), 1)
                seen[t] = math.log(max(doc_count, 2) / n)
    vocab = sorted(seen, key=lambda t: -seen[t])[:max_vocab]
    index = {t: i for i, t in enumerate(vocab)}
    X = np.zeros((len(term_lists), len(vocab)), np.float32)
    for r, terms in enumerate(term_lists):
        for t, wdf in terms.items():
            c = index.get(t)
            if c is not None:
                X[r, c] = (1.0 + math.log(max(wdf, 1))) * seen[t]
        norm = np.linalg.norm(X[r])
        if norm > 0:
            X[r] /= norm
    return X, vocab


def kmeans_cosine(X: np.ndarray, k: int, iters: int = 20,
                  seed: int = 0, device=None):
    """Spherical k-means on the card (``device`` None means ``cuda``);
    returns (labels [n], centroids)."""
    import torch

    from xapiand_tpu_torch.ops import kernels

    n, v = X.shape
    k = min(k, n)
    # deterministic farthest-first seeding: start from doc 0, repeatedly
    # take the point least similar to any chosen centroid - lands one seed
    # per natural cluster on block-structured similarity
    chosen = [0]
    sims_to_chosen = X @ X[0]
    for _ in range(k - 1):
        nxt = int(np.argmin(sims_to_chosen))
        chosen.append(nxt)
        sims_to_chosen = np.maximum(sims_to_chosen, X @ X[nxt])
    dev = torch.device("cuda" if device is None else device)
    C = torch.from_numpy(np.ascontiguousarray(X[chosen], np.float32)).to(dev)
    Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
    labels, C = kernels.kmeans_loop(Xd, C, iters)
    return labels.cpu().numpy(), C.cpu().numpy()


def label_margin_bound(v: int, dc: float = 0.0) -> float:
    """The top-2 margin (of a row's exact similarities to centroids C, see
    ``top2_margins``) above which every float32 evaluation of the row's
    label picks the same centroid. A float32 dot product of length v of
    unit vectors lies within gamma_v = v*u / (1 - v*u), u = 2**-24, of the
    exact one (any summation order), so two evaluations keep the order of
    two similarities further apart than 2*gamma_v; centroids C' with
    ||C'[c] - C[c]|| <= dc move each similarity by up to dc more."""
    u = 2.0 ** -24
    return 2.0 * v * u / (1.0 - v * u) + 2.0 * dc


def top2_margins(X: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Per row, its greatest similarity to C less its second (float64;
    inf with one centroid)."""
    sims = np.asarray(X, np.float64) @ np.asarray(C, np.float64).T
    if sims.shape[1] < 2:
        return np.full(sims.shape[0], np.inf)
    top = np.sort(sims, axis=1)[:, -2:]
    return top[:, 1] - top[:, 0]


def near_ties(X: np.ndarray, C: np.ndarray, dc: float = 0.0) -> np.ndarray:
    """The rows whose label two float32 evaluations may give differently:
    a positive greatest similarity and a top-2 margin within
    label_margin_bound(V, dc). X and C are non-negative (TF-IDF rows and
    their centroids), so a row whose greatest similarity is 0 has every
    product 0: every evaluation sums zeros and takes centroid 0."""
    X64 = np.asarray(X, np.float64)
    top = (X64 @ np.asarray(C, np.float64).T).max(axis=1) if len(C) else \
        np.zeros(len(X64))
    return (top2_margins(X64, C) <= label_margin_bound(X64.shape[1], dc)) \
        & (top > 0)


def diversify_mmr(scores: np.ndarray, X: np.ndarray, k: int,
                  lam: float = 0.5) -> list[int]:
    """Maximal-marginal-relevance reorder: next = argmax
    lam*score - (1-lam)*max_sim(selected). Returns selected row indices
    in output order (diversify/ GLS analog)."""
    n = len(scores)
    k = min(k, n)
    if n == 0:
        return []
    s = np.asarray(scores, np.float64)
    rng = s.max() - s.min()
    s = (s - s.min()) / rng if rng > 0 else np.ones_like(s)
    sims = X @ X.T
    selected = [int(np.argmax(s))]
    remaining = set(range(n)) - set(selected)
    while len(selected) < k and remaining:
        rem = sorted(remaining)
        max_sim = sims[np.ix_(rem, selected)].max(axis=1)
        mmr = lam * s[rem] - (1 - lam) * max_sim
        best = rem[int(np.argmax(mmr))]
        selected.append(best)
        remaining.discard(best)
    return selected
