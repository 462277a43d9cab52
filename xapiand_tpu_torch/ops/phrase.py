"""Positional verification: PHRASE / NEAR leaves (K14, with the K15
lookups inside it), the counterpart of ``xapiand_tpu/ops/phrase.py``.

``phrase_leaves`` is the wrapper of ``csrc/phrase_leaves.cu``; its plain
version ``_phrase_leaves_plain`` is the JAX function's algorithm in
PyTorch ops: candidates (owner rows carrying every phrase group bit)
sorted by docid and cut to ``cand_cap``, each phrase term's posting found
by a search of its docid-ascending term block, its first ``pmax``
positions gathered, and the [C, pmax, pmax] broadcast compares of
phrase.py 89-105. Both give one int32 word per row: bit p is phrase leaf
p's verdict at the doc's owner row (0 elsewhere); ``filter_leaves``
evaluates the tree over it.

The semantics, deviations included, are the JAX package's:

  PHRASE: some p0 of t0 has p0 + i among the positions of ti, every i.
  NEAR:   some p0 of t0 has, for every i, a position q of ti with
          |q - p0| < window (anchor-based).
  Only the first cand_cap candidates by docid are verified (the rest are
  false), and only the first pmax positions of each (term, doc) count.

``cfg.phrase_carry`` changes how the JAX package finds each candidate's
position block (the posting slot rides its docid sort); the port finds it
by binary search either way, so both settings run this one path.
"""

from __future__ import annotations

import torch

from xapiand_tpu_torch.ops.kernels import (MAX_CAND_CAP, MAX_PHRASE_TERMS,
                                           MAX_PHRASES, MAX_PMAX, SENTINEL,
                                           _check, _ints, _launch, _on_cuda,
                                           _stream, row_offsets)

PH_COLS = 4 + MAX_PHRASE_TERMS   # csrc/phrase_leaves.cu's table row


def check_phrases(phrases, cand_cap: int, pmax: int):
    """NotImplementedError, naming K14, for a plan beyond the kernel's
    limits."""
    checks = (
        (len(phrases) > MAX_PHRASES,
         f"more than {MAX_PHRASES} phrase leaves in one plan"),
        (any(len(p[0]) > MAX_PHRASE_TERMS for p in phrases),
         f"a phrase of more than {MAX_PHRASE_TERMS} terms"),
        (cand_cap > MAX_CAND_CAP,
         f"cand_cap {cand_cap} above {MAX_CAND_CAP}"),
        (pmax > MAX_PMAX, f"pmax {pmax} above {MAX_PMAX}"),
    )
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"not ported yet: {what} (ROADMAP "
                                      "queue 2, K14)")


def phrase_table(phrases) -> tuple:
    """ExecConfig.phrases -> the kernel's int32 table: per leaf n_terms,
    exact, window, 0, then the term indices, zero-padded to PH_COLS."""
    out: list = []
    for term_idxs, _groups, window, exact in phrases:
        row = [len(term_idxs), int(bool(exact)), int(window), 0]
        row += [int(t) for t in term_idxs]
        out += row + [0] * (PH_COLS - len(row))
    return tuple(out)


def phrase_leaves(ids, widths, offsets, lens, orbits, first, posoff, poslen,
                  positions, phrases, cand_cap: int, pmax: int):
    """The verdict word of every row for the plan's phrase leaves.

    ids i32[B,R] (score_slices: term blocks docid-ascending, SENTINEL past
    each term's postings), widths the term blocks' widths; offsets / lens
    i32[B,T] (the plan's posting spans); orbits i32[B,R] and first
    bool[B,R] (merge_docs: the doc's OR of group bits, owner & not
    deleted); posoff / poslen i32[P] and positions i32[PP] (the segment's
    positional arrays); phrases: ExecConfig.phrases; cand_cap, pmax: the
    plan's caps.
    -> phbits i32[B,R] (bit p set at the owner row of each doc phrase
       leaf p holds for), ncand i32[B,NP] (candidates verified: the first
       cand_cap at most)."""
    widths = tuple(int(w) for w in widths)
    B, R = ids.shape
    T = len(widths)
    check_phrases(phrases, cand_cap, pmax)
    if not phrases or any(not 0 <= t < T for p in phrases for t in p[0]):
        raise ValueError(f"phrase_leaves: phrases {phrases} over {T} terms")
    _check("phrase_leaves.ids", ids, torch.int32, (B, sum(widths)))
    _check("phrase_leaves.offsets", offsets, torch.int32, (B, T))
    _check("phrase_leaves.lens", lens, torch.int32, (B, T))
    _check("phrase_leaves.orbits", orbits, torch.int32, (B, R))
    _check("phrase_leaves.first", first, torch.bool, (B, R))
    for name, t in (("posoff", posoff), ("poslen", poslen),
                    ("positions", positions)):
        _check(f"phrase_leaves.{name}", t, torch.int32)
    if not _on_cuda("phrase_leaves", ids, offsets, lens, orbits, first,
                    posoff, poslen, positions):
        return _phrase_leaves_plain(ids, widths, offsets, lens, orbits,
                                    first, posoff, poslen, positions,
                                    phrases, cand_cap, pmax)
    dev = ids.device
    NP = len(phrases)
    phbits = torch.zeros((B, R), dtype=torch.int32, device=dev)
    ncand = torch.empty((B, NP), dtype=torch.int32, device=dev)
    _launch("phrase_leaves", "xt_phrase_leaves", ids.data_ptr(),
            _ints(widths, dev).data_ptr(),
            _ints(row_offsets(widths), dev).data_ptr(), B, T, R,
            offsets.data_ptr(), lens.data_ptr(), first.data_ptr(),
            posoff.data_ptr(), poslen.data_ptr(), positions.data_ptr(),
            _ints(phrase_table(phrases), dev).data_ptr(), NP, int(cand_cap),
            int(pmax), phbits.data_ptr(), ncand.data_ptr(), _stream())
    return phbits, ncand


def phrase_candidates(ids, widths, offsets, orbits, first, posoff, poslen,
                      term_idxs, group_idxs, cand_cap: int, pmax: int):
    """The candidates of one phrase leaf as phrase.py 41-87 forms them
    (the term blocks of ``ids`` are SENTINEL past each term's postings).
    -> cand_d i32[B,C] (ascending docids, SENTINEL past the candidates),
       src i64[B,C] (each candidate's row), valid bool[B,C], and per
       phrase term (found bool[B,C], poff i64[B,C], plen i64[B,C]); C =
       min(cand_cap, R)."""
    R = ids.shape[1]
    allbits = 0
    for g in group_idxs:
        allbits |= 1 << int(g)
    ok = first & ((orbits & allbits) == allbits)
    cand_d, src = torch.sort(torch.where(ok, ids, SENTINEL), dim=1,
                             stable=True)
    C = min(int(cand_cap), R)
    cand_d, src = cand_d[:, :C].contiguous(), src[:, :C]
    valid = cand_d != SENTINEL
    ro = row_offsets(widths)
    n = posoff.shape[0]
    per_term = []
    for t in term_idxs:
        W = widths[t]
        blk = ids[:, ro[t]:ro[t + 1]].contiguous()
        jc = torch.searchsorted(blk, cand_d).clamp(max=W - 1)
        found = (torch.gather(blk, 1, jc) == cand_d) & valid
        slot = (offsets[:, t:t + 1].long() + jc).clamp(max=n - 1)
        per_term.append((found, posoff[slot].long(),
                         poslen[slot].long().clamp(max=pmax)))
    return cand_d, src, valid, per_term


def _phrase_leaves_plain(ids, widths, offsets, lens, orbits, first, posoff,
                         poslen, positions, phrases, cand_cap, pmax):
    B, R = ids.shape
    dev = ids.device
    phbits = torch.zeros((B, R), dtype=torch.int32, device=dev)
    ncand = torch.zeros((B, len(phrases)), dtype=torch.int32, device=dev)
    ar = torch.arange(pmax, device=dev)
    last = positions.shape[0] - 1
    for p, (term_idxs, group_idxs, window, exact) in enumerate(phrases):
        _d, src, valid, per_term = phrase_candidates(
            ids, widths, offsets, orbits, first, posoff, poslen, term_idxs,
            group_idxs, cand_cap, pmax)
        lists = [(positions[(poff[..., None] + ar).clamp(max=last)],
                  (ar < plen[..., None]) & found[..., None])
                 for found, poff, plen in per_term]      # [B, C, pmax]
        C = valid.shape[1]
        verdict = torch.zeros((B, C), dtype=torch.bool, device=dev)
        step = max(1, 2**24 // max(B * pmax * pmax, 1))
        for c0 in range(0, C, step):
            cs = slice(c0, c0 + step)
            p0, surv = lists[0][0][:, cs], lists[0][1][:, cs]
            for i, (pi, vi) in enumerate(lists[1:], start=1):
                pi, vi = pi[:, cs], vi[:, cs]
                if exact:
                    hit = (p0[..., :, None] + i) == pi[..., None, :]
                else:
                    hit = (pi[..., None, :] - p0[..., :, None]).abs() < window
                surv = surv & (hit & vi[..., None, :]).any(-1)
            verdict[:, cs] = surv.any(-1)
        row = torch.zeros((B, R), dtype=torch.bool, device=dev).scatter_(
            1, src, verdict & valid)
        phbits |= row.to(torch.int32) << p
        ncand[:, p] = valid.sum(1, dtype=torch.int32)
    return phbits, ncand
