"""Supervised execution and recovery of the training runtimes
(``repro/runtime``: the supervision primitives and the embedding-runtime
supervisor; the LM ``TrainSupervisor`` waits for LM training)."""
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    EmbeddingTrainSupervisor,
    FailureInjector,
    PreemptionHandler,
    SupervisorReport,
    TrainSupervisor,
)
from repro_torch.runtime.supervision import (  # noqa: F401
    OpSupervisor,
    OpTimeoutError,
    SupervisePolicy,
    SupervisedOp,
    TransientOpError,
)
