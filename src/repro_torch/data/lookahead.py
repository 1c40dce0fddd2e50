"""Look-ahead dataset stream: the mechanism that lets ScratchPipe see the
"future" (paper §IV-A — the training dataset records upcoming sparse ids).

Port of ``repro/data/lookahead.py``, copied unchanged (pure Python + numpy).
Wraps any (ids, batch) iterator with a peek buffer, completely transparent
to the consumer (the paper's "transparent to the ML framework" property).
``state_dict`` records the stream position so a restart can resume with an
identical pipeline schedule.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Iterator, List, Tuple

import numpy as np


class LookaheadStream:
    def __init__(self, it: Iterator[Tuple[np.ndarray, Any]]):
        self._it = iter(it)
        self._buf: collections.deque = collections.deque()
        self._consumed = 0
        self._src_exhausted = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._buf:
            item = self._buf.popleft()
        else:
            try:
                item = next(self._it)
            except StopIteration:
                self._src_exhausted = True
                raise
        self._consumed += 1
        return item

    def peek_ids(self, k: int) -> List[np.ndarray]:
        """ids of the next k batches WITHOUT consuming them."""
        while len(self._buf) < k:
            try:
                self._buf.append(next(self._it))
            except StopIteration:
                self._src_exhausted = True
                break
        return [self._buf[i][0] for i in range(min(k, len(self._buf)))]

    @property
    def exhausted(self) -> bool:
        """True iff the stream is drained: the source iterator has ended AND
        no buffered batches remain. Disambiguates a short ``peek_ids``
        window (look-ahead reached the end) from an empty stream — the
        pipeline's drain path keys off this instead of a sentinel probe."""
        return self._src_exhausted and not self._buf

    def peek_table_ids(self, k: int, group) -> List[List[np.ndarray]]:
        """Per-table LOCAL id streams of the next k batches (one list of
        ``group.num_tables`` arrays per upcoming batch) — the look-ahead view
        a per-table cache manager plans against."""
        return [group.split(ids) for ids in self.peek_ids(k)]

    @property
    def consumed(self) -> int:
        return self._consumed

    def state_dict(self) -> dict:
        return {"consumed": self._consumed}


def make_stream(factory: Callable[[], Iterator], skip: int = 0) -> LookaheadStream:
    """Rebuild a stream from its factory, skipping ``skip`` consumed batches
    (elastic/restart path — deterministic generators replay identically)."""
    it = factory()
    for _ in range(skip):
        next(it)
    s = LookaheadStream(it)
    s._consumed = skip
    return s
