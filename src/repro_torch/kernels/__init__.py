"""The port's kernels: hand-written CUDA (``csrc/``), their ctypes launchers
(``gather_reduce.py``, ``grad_coalesce.py``, ``flash_attention.py``,
``ssd_chunk.py``), their plain PyTorch versions (``ref.py``) and the
device-dispatching wrappers (``ops.py``)."""
