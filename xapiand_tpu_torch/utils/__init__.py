"""Host utilities (torch port): copies of the JAX package's jax-free
``utils`` modules the port needs (synthetic corpus, serialisation, string
metrics), held equal to their originals by ``tests/test_torch_import.py``,
and the port's own faceted corpus generator (``synth_faceted.py``)."""
