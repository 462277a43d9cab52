"""xapiand_tpu_torch: the PyTorch + CUDA port of the xapiand_tpu device plane.

The JAX package (``xapiand_tpu``) is the reference. This package mirrors its
layout module for module and imports ``torch``, never ``jax`` and nothing of
the JAX package. The jax-free host modules the slice needs (the host
``Segment`` in ``models/segment.py``, ``query/ir.py``, ``query/plan.py``,
``utils/synth.py``, ``utils/serialise.py``, ``utils/strmetrics.py``,
``utils/phonetic.py``) are copies of the JAX package's files with their
package imports pointed here; ``tests/test_torch_import.py`` holds each
copy's text equal to its original.

Slice 1 covers BM25 top-k over relevance OR queries (``BatchSearcher`` with
impact-prefix pruning and the exact re-run of uncertified queries); slice 2
the predicate path of filtered, value-sorted faceted search (boolean trees,
deletes, value filters, multi-key sorts, compaction; its corpus is
``utils/synth_faceted.py``). The device kernels are hand-written CUDA C++
for ``sm_90a`` (``csrc/``), built at first use; on CPU tensors every kernel
wrapper runs its plain PyTorch version instead (``ops/kernels.py``).
"""

__version__ = "0.1.0"
