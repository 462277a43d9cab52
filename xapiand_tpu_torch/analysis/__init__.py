"""Accuracy terms (``accuracy.py``, a pinned copy of the JAX package's).

The JAX package's ``analysis/__init__.py`` imports its tokenizer and term
generator, which need the host analysis packages; the port has no text
analysis chain, so its package imports nothing."""
