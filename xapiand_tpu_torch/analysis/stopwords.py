"""Stopword lists.

Reference parity target: /stopwords/*.txt (Snowball-project stopword lists
loaded per language). We embed a standard English list and support loading
additional per-language lists from a directory at runtime
(``load_stopwords_dir``) so deployments can ship the full multilingual set.
"""

from __future__ import annotations

import os
from functools import lru_cache

_ENGLISH = """
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for from
further had hadn't has hasn't have haven't having he he'd he'll he's her here
here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of
off on once only or other ought our ours ourselves out over own same shan't
she she'd she'll she's should shouldn't so some such than that that's the
their theirs them themselves then there there's these they they'd they'll
they're they've this those through to too under until up very was wasn't we
we'd we'll we're we've were weren't what what's when when's where where's
which while who who's whom why why's with won't would wouldn't you you'd
you'll you're you've your yours yourself yourselves
""".split()

_registry: dict[str, frozenset[str]] = {"english": frozenset(_ENGLISH)}


def get_stopwords(lang: str | None) -> frozenset[str]:
    if not lang:
        return frozenset()
    from xapiand_tpu_torch.analysis.stem import resolve_language

    resolved = resolve_language(lang) or lang.lower()
    return _registry.get(resolved, frozenset())


def register_stopwords(lang: str, words) -> None:
    _registry[lang.lower()] = frozenset(w.strip().lower() for w in words if w.strip())


def load_stopwords_dir(path: str) -> int:
    """Load <lang>.txt files (one word per line) from a directory; returns
    the number of languages loaded. Mirrors the reference's stopwords/ dir."""
    count = 0
    for name in os.listdir(path):
        if not name.endswith(".txt"):
            continue
        lang = name[:-4]
        with open(os.path.join(path, name), encoding="utf-8") as fh:
            register_stopwords(lang, fh.read().split())
        count += 1
    return count


@lru_cache(maxsize=64)
def is_stopword(word: str, lang: str = "english") -> bool:
    return word in get_stopwords(lang)
