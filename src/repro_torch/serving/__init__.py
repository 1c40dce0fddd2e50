"""Online serving: paced replay of request micro-batches through a
read-only cache runtime, and the front end that micro-batches concurrent
single-request lookups into its cycles (the queue is the look-ahead
window)."""
from repro_torch.serving.driver import replay_serving, summarize_latencies
from repro_torch.serving.frontend import EmbeddingServer

__all__ = ["EmbeddingServer", "replay_serving", "summarize_latencies"]
