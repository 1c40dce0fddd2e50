"""Optimizers of the port (``repro/optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    SGD,
    AdamW,
    RowWiseAdagrad,
    clip_by_global_norm,
    global_norm,
    warmup_cosine,
)
