"""PyTorch + CUDA port of the ScratchPipe reproduction, for NVIDIA Hopper.

Mirrors the JAX package ``repro`` module for module (``repro_torch/X.py`` is
held against ``repro/X.py``), and imports nothing of it. Plain tensor code
is PyTorch; every Pallas kernel on a ported path is a hand-written CUDA
kernel under ``kernels/csrc/``, dispatched by the tensor's device
(``kernels/ops.py``). Ported so far: the DLRM embedding serving path
(``launch/serve.py --embedding``; ``nocache-serve`` and
``scratchpipe-serve``) and DLRM training (``launch/train.py``;
``scratchpipe`` split and fused, ``strawman``, ``nocache``, ``static``;
fp32 and fp16/int8 replicas), with the ``gather_reduce``,
``gather_reduce_q``, ``fill``, ``fill_gather_reduce``,
``fill_gather_reduce_q`` and ``scatter_add`` kernels; and LM serving of
zamba2-1.2b (``launch/serve.py --arch``: prefill + greedy decode) with the
``flash_attention`` and ``ssd_chunk_scan`` kernels. Beside them:
telemetry (``obs/``: spans on every pipeline thread, metrics, their
validators) and the recovery of DLRM training (``checkpoint/``,
``runtime/``, ``chaos/``: crash-consistent checkpoints at any cycle, the
supervised overlapped executor, fault injection).
"""
