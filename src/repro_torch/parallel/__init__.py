"""Sharding rules and collectives of the port (``parallel/sharding.py``,
``parallel/collectives.py``) on ``torch.distributed``."""
