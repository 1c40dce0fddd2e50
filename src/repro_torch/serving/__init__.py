"""Serving drivers: paced replay of request micro-batches through a
read-only cache runtime (the queue is the look-ahead window)."""
from repro_torch.serving.driver import replay_serving, summarize_latencies

__all__ = ["replay_serving", "summarize_latencies"]
