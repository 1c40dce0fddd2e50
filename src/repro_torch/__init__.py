"""PyTorch + CUDA port of the ScratchPipe reproduction, for NVIDIA Hopper.

Mirrors the JAX package ``repro`` module for module (``repro_torch/X.py`` is
held against ``repro/X.py``), and imports nothing of it. Plain tensor code
is PyTorch; every Pallas kernel on a ported path is a hand-written CUDA
kernel under ``kernels/csrc/``, dispatched by the tensor's device
(``kernels/ops.py``). Ported so far: the DLRM embedding serving path
(``launch/serve.py --embedding``; ``nocache-serve`` and
``scratchpipe-serve``) with the ``gather_reduce`` and ``fill`` kernels.
"""
