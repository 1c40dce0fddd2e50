"""Multi-manager ScratchPipe (paper §VI-G): table-wise model parallelism.

Port of ``repro/core/sharded_pipeline.py``. The paper argues ScratchPipe
extends to multi-GPU by instantiating one cache manager per embedding-table
partition — each device treats its partition as an independent table, so
no inter-device RAW hazards or index reordering arise.
``ShardedScratchPipe`` realizes that: the global row space is range-
partitioned into N shards, each with its own host-table slice, planner and
scratchpad storage; a mini-batch's ids are bucketed per shard and every
shard runs the same 6-stage schedule in lockstep. The [Train] stage
receives per-shard (storage, slots) so the model's gather/scatter runs
against the manager that owns each row. As in the reference, every shard's
scratchpad lives on the one ``device``: N independent buffers, which keeps
all scheduling and correctness semantics (tests/test_torch_sharded.py:
bitwise equal to the single-manager runtime).

The global [Train] is deferred: shards 0..N-2 return their storage
untouched from their [Train] stage, and ``train_fn(storages,
slots_per_shard, batch)`` fires at the last shard's. That is sound because
[Train] is the last stage of a shard's cycle (its fill comes before it),
and the next round's victim reads come after it. The storages are updated
IN PLACE, as every [Train] of the port does; every launch stays on the
calling thread, also under ``executor="overlapped"`` (N x 2 worker threads
that run numpy and wait on events).

Partitioning is either uniform (``num_shards`` equal ranges) or follows a
:class:`~repro_torch.core.table_group.TableGroup` (``from_group``: one
cache manager per embedding table, with per-table scratchpad budgets and
each table's own replica precision — the route to MIXED per-table
precisions, which one storage cannot hold).

``tracer``/``metrics`` and ``supervise`` pass through to every shard (its
cells labelled ``shard=<i>``; a watchdog of its own over its own pools);
``state_arrays``/``load_state_arrays`` snapshot every shard under
``shard<i>_`` keys between lockstep cycles, each shard's host table loading
in place into the caller's table.

The reference's ``kernel=`` and ``pad_buckets=`` options are not carried
over: no caller of the port sets them (``sharded`` is not a ``--runtime``
choice, so ``--adaptive-pad`` never reaches it; each shard pads to the
pow-2 default).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.host_table import HostEmbeddingTable, HostTraffic
from repro_torch.core.pipeline import ScratchPipe, StepStats
from repro_torch.core.runtime import register_runtime
from repro_torch.core.table_group import TableGroup


class ShardedScratchPipe:
    def __init__(
        self,
        host_table: HostEmbeddingTable,
        num_slots: Union[int, Sequence[int]],
        num_shards: int,
        train_fn: Callable[[Sequence, Sequence, Any], Tuple[Sequence, Any]],
        *,
        past_window: int = 3,
        future_window: int = 2,
        boundaries: Optional[Sequence[int]] = None,
        executor: str = "sync",
        planner: str = "host",
        precision: Union[str, Sequence[str], None] = None,
        tracer=None,
        metrics=None,
        supervise=None,
        device="cuda",
    ):
        """``train_fn(storages, slots_per_shard, batch)`` ->
        (storages, aux), the storages updated in place. ``num_slots`` is
        the per-shard scratchpad size (int: same for every shard; sequence:
        one per shard). ``boundaries`` (len num_shards+1) range-partitions
        the global row space; default: equal split (the table must then
        shard evenly). ``precision`` is the per-shard replica precision
        (str: uniform; sequence: one per shard). Per-shard ``num_slots``
        stay NOMINAL (fp32-row byte budgets); each manager applies its own
        capacity multiplier."""
        rows = host_table.rows
        if boundaries is None:
            assert rows % num_shards == 0, (rows, num_shards)
            step = rows // num_shards
            boundaries = [i * step for i in range(num_shards + 1)]
        assert len(boundaries) == num_shards + 1, (len(boundaries), num_shards)
        assert boundaries[0] == 0 and boundaries[-1] == rows, boundaries
        self.boundaries = np.asarray(boundaries, dtype=np.int64)
        shard_rows = np.diff(self.boundaries)
        self.rows_per_shard = (
            int(shard_rows[0]) if len(set(shard_rows.tolist())) == 1 else None
        )
        self.num_shards = num_shards
        if isinstance(num_slots, int):
            num_slots = [num_slots] * num_shards
        assert len(num_slots) == num_shards, (num_slots, num_shards)
        if precision is None or isinstance(precision, str):
            precision = [precision or "fp32"] * num_shards
        precision = list(precision)
        assert len(precision) == num_shards, (precision, num_shards)
        self.precisions = tuple(precision)
        self.train_fn = train_fn
        self._pending: dict = {}

        def shard_train_fn(shard_idx):
            def fn(storage, slots, batch):
                # collect all shards' [Train] inputs; fire on the last shard
                self._pending[shard_idx] = (storage, slots)
                if len(self._pending) < self.num_shards:
                    return storage, None
                storages = [self._pending[i][0] for i in range(self.num_shards)]
                slots_all = [self._pending[i][1] for i in range(self.num_shards)]
                self._pending = {}
                new_storages, aux = self.train_fn(storages, slots_all, batch)
                for i, pipe in enumerate(self.pipes):
                    if i != shard_idx:
                        pipe.storage = new_storages[i]
                return new_storages[shard_idx], aux

            return fn

        # per-shard host tables are views of the one array (zero-copy
        # slices): flush_to_host and the write-backs land in the caller's table
        self.pipes: List[ScratchPipe] = []
        for i in range(num_shards):
            lo, hi = int(self.boundaries[i]), int(self.boundaries[i + 1])
            ht = HostEmbeddingTable(hi - lo, host_table.dim, data=host_table.data[lo:hi])
            self.pipes.append(
                ScratchPipe(
                    ht,
                    int(num_slots[i]),
                    shard_train_fn(i),
                    past_window=past_window,
                    future_window=future_window,
                    executor=executor,
                    # planner="device": one device-resident plan state per
                    # shard; its variable-length id stream is absorbed by
                    # the planner's monotone pad lengths
                    planner=planner,
                    precision=precision[i],
                    tracer=tracer,
                    metrics=metrics,
                    # per-shard metric cells: same names, one label apart
                    obs_labels={"shard": str(i)},
                    # each shard's own watchdog over its own pools
                    supervise=supervise,
                    device=device,
                )
            )

    @classmethod
    def from_group(
        cls,
        host_table: HostEmbeddingTable,
        num_slots: int,
        group: TableGroup,
        train_fn,
        **kw,
    ) -> "ShardedScratchPipe":
        """One cache manager per embedding table; ``num_slots`` total slots
        split into per-table budgets by the group's hot-set weights. Each
        table's ``precision`` (TableSpec) selects its manager's replica
        format unless an explicit ``precision=`` kw overrides it."""
        assert host_table.rows == group.total_rows, (
            host_table.rows,
            group.total_rows,
        )
        kw.setdefault("precision", [t.precision for t in group.tables])
        return cls(
            host_table,
            group.slot_budgets(num_slots),
            group.num_tables,
            train_fn,
            boundaries=group.offsets.tolist(),
            **kw,
        )

    def _bucket(self, ids: np.ndarray) -> List[np.ndarray]:
        """Row ids -> per-shard LOCAL ids. ScratchPipe plans per table
        partition, so each shard receives only ids in its range; shapes vary
        per shard, which the per-shard [Train] slots reflect."""
        out = []
        flat = np.asarray(ids).ravel()
        for i in range(self.num_shards):
            lo, hi = int(self.boundaries[i]), int(self.boundaries[i + 1])
            out.append(flat[(flat >= lo) & (flat < hi)] - lo)
        return out

    def run(self, stream: Iterator, lookahead_fn=None) -> List[StepStats]:
        """Lockstep: every shard advances one pipeline cycle per mini-batch
        round; the global [Train] fires once all shards reach their [Train]
        stage for the same batch. Returns the last shard's per-step stats
        (its aux carries the global [Train]'s)."""
        items = list(stream)  # materialize (lockstep needs aligned views)
        shard_streams = [[] for _ in range(self.num_shards)]
        for ids, batch in items:
            for i, b in enumerate(self._bucket(np.asarray(ids))):
                shard_streams[i].append((b, batch))

        def look(i):
            def fn(k):
                nxt = self.pipes[i].planner._cycle + 1
                arr = shard_streams[i]
                return [arr[nxt + j][0] for j in range(k) if nxt + j < len(arr)]

            return fn

        outs: List[List[StepStats]] = [[] for _ in range(self.num_shards)]
        for step in range(len(items)):
            for i, pipe in enumerate(self.pipes):
                ids, batch = shard_streams[i][step]
                st = pipe.run_one_cycle(ids, batch, look(i))
                if st is not None:
                    outs[i].append(st)
        while any(p._window for p in self.pipes):
            for i, pipe in enumerate(self.pipes):
                if pipe._window:
                    st = pipe.drain_one_cycle()
                    if st is not None:
                        outs[i].append(st)
        self._barrier()
        return outs[-1]

    def _barrier(self) -> None:
        """Quiesce every shard's overlapped-executor work."""
        for pipe in self.pipes:
            pipe._barrier()

    def close(self) -> None:
        """Release every shard's overlapped-executor worker threads."""
        for pipe in self.pipes:
            pipe.close()

    def run_one_cycle(self, ids, batch, lookahead_fn=None) -> Optional[StepStats]:
        """Admit one mini-batch (global ids) to every shard and advance each
        one cycle. ``lookahead_fn(k)`` yields upcoming GLOBAL id batches;
        they are bucketed per shard. Returns the last shard's completed
        StepStats (aux carries the global [Train]'s), or None while
        filling."""
        buckets = self._bucket(np.asarray(ids))
        fut_cache: dict = {}  # k -> per-batch bucket lists (bucketed once)

        def look(i):
            def fn(k):
                if k not in fut_cache:
                    fut_cache[k] = [self._bucket(np.asarray(b)) for b in lookahead_fn(k)]
                return [bb[i] for bb in fut_cache[k]]

            return fn

        st_last: Optional[StepStats] = None
        for i, pipe in enumerate(self.pipes):
            st = pipe.run_one_cycle(buckets[i], batch, look(i) if lookahead_fn else None)
            if i == self.num_shards - 1:
                st_last = st
        return st_last

    def drain_one_cycle(self) -> Optional[StepStats]:
        """Advance every shard one cycle without a new batch (lockstep
        drain). Returns the last shard's completed StepStats, if any."""
        st_last: Optional[StepStats] = None
        for i, pipe in enumerate(self.pipes):
            if pipe._window:
                st = pipe.drain_one_cycle()
                if i == self.num_shards - 1:
                    st_last = st
        return st_last

    def flush_to_host(self):
        for pipe in self.pipes:
            pipe.flush_to_host()

    # -- checkpoint/restart (crash-consistent, ANY lockstep boundary) ------ #
    def state_arrays(self) -> dict:
        """Every shard's :meth:`ScratchPipe.state_arrays` under
        ``shard<i>_<key>``. Called between lockstep cycles (every shard has
        fired its [Train] or none has: no [Train] input is held), so a
        restored N-shard run is bitwise equal to the uninterrupted one."""
        if self._pending:
            raise RuntimeError("checkpoint only between lockstep cycles")
        out: dict = {}
        for i, pipe in enumerate(self.pipes):
            for k, v in pipe.state_arrays().items():
                out[f"shard{i}_{k}"] = v
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        """Split the shard-indexed keys and load each shard; shard host
        tables load IN PLACE, so the caller's table stays the one trained."""
        self._pending = {}
        for i, pipe in enumerate(self.pipes):
            prefix = f"shard{i}_"
            sub = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}
            if not sub:
                raise KeyError(f"checkpoint has no arrays for shard {i}")
            pipe.load_state_arrays(sub)

    @property
    def stats(self) -> List[StepStats]:
        """Last shard's per-step stats (its aux carries the global loss)."""
        return self.pipes[-1].stats

    def traffic(self) -> dict:
        """Aggregated byte counters across all shard managers."""
        agg = {k: HostTraffic() for k in ("host", "pcie", "hbm")}
        for pipe in self.pipes:
            for k, t in pipe.traffic().items():
                agg[k].read += t.read
                agg[k].written += t.written
        return agg


@register_runtime("sharded")
def _make_sharded(
    host_table,
    train_fn,
    *,
    num_slots,
    table_group=None,
    num_shards=None,
    slot_budgets=None,
    **kw,
) -> ShardedScratchPipe:
    """table_group: one shard per table (per-table budgets; explicit
    ``slot_budgets`` override the proportional split); otherwise a uniform
    ``num_shards`` range partition."""
    if table_group is not None:
        kw.setdefault("precision", [t.precision for t in table_group.tables])
        if slot_budgets is not None:
            return ShardedScratchPipe(
                host_table,
                list(slot_budgets),
                table_group.num_tables,
                train_fn,
                boundaries=table_group.offsets.tolist(),
                **kw,
            )
        return ShardedScratchPipe.from_group(
            host_table, num_slots, table_group, train_fn, **kw
        )
    if slot_budgets is not None:
        raise TypeError("sharded: slot_budgets requires table_group")
    return ShardedScratchPipe(host_table, num_slots, num_shards or 1, train_fn, **kw)
