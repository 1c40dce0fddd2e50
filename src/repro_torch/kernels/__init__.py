"""The port's kernels: hand-written CUDA (``csrc/``), their ctypes launchers
(``gather_reduce.py``), their plain PyTorch versions (``ref.py``) and the
device-dispatching wrappers (``ops.py``)."""
