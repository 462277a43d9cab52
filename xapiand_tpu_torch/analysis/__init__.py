"""Text analysis (torch port): pinned copies of the JAX package's
tokenizer, stopwords, term generator, accuracy terms and pure-Python
stemmers, and the port's own ``stem.py``, which stems English without
nltk (see its docstring).

Like the JAX package's ``analysis/__init__.py`` it exposes the term
generator and the tokenizer; importing it needs no nltk."""

from xapiand_tpu_torch.analysis.termgen import TermGenerator, STEM_SOME, STEM_ALL, STEM_ALL_Z, STEM_NONE  # noqa: F401
from xapiand_tpu_torch.analysis.unicode_tok import tokenize  # noqa: F401
