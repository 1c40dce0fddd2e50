"""dlrm-scratchpipe: the paper's own RecSys model (§V methodology).

Port of ``config`` and ``smoke_config`` of ``repro/configs/dlrm_scratchpipe.py``:
8 embedding tables x 10M rows x 128-dim fp32 (= 40 GB model), 20 gathers
per table, batch 2048, DLRM bottom/top MLPs (MLPerf DLRM), dot-product
feature interaction.
"""
from repro_torch.configs.base import DLRMConfig


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
