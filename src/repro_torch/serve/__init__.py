from repro_torch.serve.admission import (
    AdmissionDecision,
    AdmissionPolicy,
    AdmitAll,
    LoadView,
    QualityShed,
    SLOBudget,
)
from repro_torch.serve.engine import ServeConfig, ServeEngine, StepInfo
from repro_torch.serve.scheduler import (
    FinishReason,
    QueueFullError,
    Request,
    RequestStatus,
    Scheduler,
    SlotState,
    SpecConfig,
    SubmitRejected,
)

__all__ = [
    "AdmissionDecision",
    "AdmissionPolicy",
    "AdmitAll",
    "FinishReason",
    "LoadView",
    "QualityShed",
    "QueueFullError",
    "Request",
    "RequestStatus",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "SLOBudget",
    "SlotState",
    "SpecConfig",
    "StepInfo",
    "SubmitRejected",
]
