"""dlrm-scratchpipe: the paper's own RecSys model (§V methodology).

Port of the configs of ``repro/configs/dlrm_scratchpipe.py``: 8 embedding
tables x 10M rows x 128-dim fp32 (= 40 GB model), 20 gathers per table,
batch 2048, DLRM bottom/top MLPs (MLPerf DLRM), dot-product feature
interaction; and its multi-table variants with heterogeneous per-table row
counts (``multi_table_config``, ``launch/train.py --tables N``); and its
dry-run ``ENTRY`` (the one ``dlrm_train`` cell).
"""
from repro_torch.configs.base import ArchEntry, DLRMConfig, ShapeSpec

# DLRM cells use the paper's batch; "seq_len" is reused as lookups/table.
DLRM_TRAIN = ShapeSpec("dlrm_train", 20, 2048, "train")


def config() -> DLRMConfig:
    return DLRMConfig()


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name="dlrm-smoke",
        num_tables=4,
        rows_per_table=512,
        embed_dim=16,
        lookups_per_table=4,
        num_dense_features=13,
        bottom_mlp=(32, 16),
        top_mlp=(32, 16, 1),
        batch_size=32,
        cache_fraction=0.125,
    )


def hetero_rows(num_tables: int, base_rows: int) -> tuple:
    """Criteo-style heterogeneous table sizes: geometric spread around
    ``base_rows`` with a 2x ratio between consecutive tables (largest is
    2^(num_tables-1)x the smallest, floored at 64 rows — echoing the public
    Criteo dataset's orders-of-magnitude vocabulary skew)."""
    return tuple(
        max(64, int(base_rows * 2.0 ** (num_tables / 2 - 1 - t)))
        for t in range(num_tables)
    )


def multi_table_config(num_tables: int = 8, base_rows: int = 10_000_000) -> DLRMConfig:
    """The paper's DLRM with HETEROGENEOUS per-table row counts — the
    realistic multi-table workload the TableGroup runtime is built for."""
    return DLRMConfig(
        name=f"dlrm-multitable-{num_tables}",
        table_rows=hetero_rows(num_tables, base_rows),
    )


def multi_table_smoke_config(num_tables: int = 4) -> DLRMConfig:
    return DLRMConfig(
        name=f"dlrm-multitable-smoke-{num_tables}",
        table_rows=hetero_rows(num_tables, 512),
        embed_dim=16,
        lookups_per_table=4,
        num_dense_features=13,
        bottom_mlp=(32, 16),
        top_mlp=(32, 16, 1),
        batch_size=32,
        cache_fraction=0.125,
    )


ENTRY = ArchEntry(
    config=config(), smoke=smoke_config(), shapes=(DLRM_TRAIN,), skips=()
)
