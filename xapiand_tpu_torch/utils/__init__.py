"""Host utilities (torch port): copies of the JAX package's jax-free
``utils`` modules the slice needs (synthetic corpus, serialisation, string
metrics), held equal to their originals by ``tests/test_torch_import.py``."""
