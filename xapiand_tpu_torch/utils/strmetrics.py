"""String similarity metrics.

Reference parity target: src/metrics/ (levenshtein, jaro(-winkler),
jaccard, sorensen_dice, lcs/lcsubstr, soundex_metric; src/string_metric.h).
Used by fuzzy sort keys (keymaker.h StringKey with metric) and
spelling/near-duplicate logic.

All ``similarity`` functions return [0, 1] (1 = identical); ``distance`` =
1 - similarity, matching the reference's Metric interface.
"""

from __future__ import annotations


def levenshtein(a: str, b: str) -> int:
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def levenshtein_similarity(a: str, b: str) -> float:
    n = max(len(a), len(b))
    return 1.0 - levenshtein(a, b) / n if n else 1.0


def jaro(a: str, b: str) -> float:
    if a == b:
        return 1.0
    la, lb = len(a), len(b)
    if not la or not lb:
        return 0.0
    window = max(la, lb) // 2 - 1
    window = max(window, 0)
    ma = [False] * la
    mb = [False] * lb
    matches = 0
    for i, ca in enumerate(a):
        lo, hi = max(0, i - window), min(lb, i + window + 1)
        for j in range(lo, hi):
            if not mb[j] and b[j] == ca:
                ma[i] = mb[j] = True
                matches += 1
                break
    if matches == 0:
        return 0.0
    t = 0
    k = 0
    for i in range(la):
        if ma[i]:
            while not mb[k]:
                k += 1
            if a[i] != b[k]:
                t += 1
            k += 1
    t //= 2
    m = matches
    return (m / la + m / lb + (m - t) / m) / 3.0


def jaro_winkler(a: str, b: str, p: float = 0.1, max_prefix: int = 4) -> float:
    j = jaro(a, b)
    prefix = 0
    for ca, cb in zip(a, b):
        if ca != cb or prefix >= max_prefix:
            break
        prefix += 1
    return j + prefix * p * (1.0 - j)


def _ngrams(s: str, n: int = 2) -> set:
    if len(s) < n:
        return {s} if s else set()
    return {s[i:i + n] for i in range(len(s) - n + 1)}


def jaccard(a: str, b: str) -> float:
    """Character-set Jaccard similarity (src/metrics/jaccard.h)."""
    sa, sb = set(a), set(b)
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / len(sa | sb)


def sorensen_dice(a: str, b: str) -> float:
    """Bigram Dice coefficient (src/metrics/sorensen_dice.h)."""
    ba, bb = _ngrams(a), _ngrams(b)
    if not ba and not bb:
        return 1.0
    if not ba or not bb:
        return 0.0
    return 2.0 * len(ba & bb) / (len(ba) + len(bb))


def lcs_length(a: str, b: str) -> int:
    """Longest common subsequence (src/metrics/lcsubsequence.h)."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for ca in a:
        cur = [0] * (len(b) + 1)
        for j, cb in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if ca == cb else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def lcs_substr_length(a: str, b: str) -> int:
    """Longest common substring (src/metrics/lcsubstr.h)."""
    if not a or not b:
        return 0
    best = 0
    prev = [0] * (len(b) + 1)
    for ca in a:
        cur = [0] * (len(b) + 1)
        for j, cb in enumerate(b, 1):
            if ca == cb:
                cur[j] = prev[j - 1] + 1
                best = max(best, cur[j])
        prev = cur
    return best


METRICS = {
    "levenshtein": levenshtein_similarity,
    "jaro": jaro,
    "jaro_winkler": jaro_winkler,
    "jaccard": jaccard,
    "sorensen_dice": sorensen_dice,
    "dice": sorensen_dice,
    "lcs_substr": lambda a, b: (lcs_substr_length(a, b)
                                / max(len(a), len(b), 1)),
    "lcs_seq": lambda a, b: lcs_length(a, b) / max(len(a), len(b), 1),
}


def similarity(a: str, b: str, metric: str = "levenshtein") -> float:
    fn = METRICS.get(metric.lower())
    if fn is None:
        if metric.lower().startswith("soundex"):
            from xapiand_tpu_torch.utils.phonetic import soundex_similarity

            return soundex_similarity(a, b)
        raise ValueError(f"unknown string metric {metric!r}")
    return fn(a, b)
