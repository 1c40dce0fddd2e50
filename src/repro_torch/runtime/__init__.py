"""Supervised execution and recovery of the training runtimes
(``repro/runtime``: the supervision primitives, the embedding-runtime
supervisor and the LM ``TrainSupervisor``)."""
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
