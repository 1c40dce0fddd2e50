"""Runnable examples of the port, ports of the JAX package's
``examples/{lm_cached_embedding,quickstart,serve_lm,train_dlrm_scratchpipe}.py``:
``python -m repro_torch.examples.<name> [--device cpu]``. Each keeps its
reference's arguments and output lines and runs on the card unless
``--device cpu`` is given."""
