"""Device-plane query execution (torch port): the batched executor and its
hand-written CUDA kernels (``kernels.py``, sources in ``../csrc``)."""
