"""The quality-dial facade of the PyTorch port: compress -> EdgeArtifact ->
engine, one import.

    from repro_torch import api

    art = api.compress(model, params, device="cuda")
    art.save("model.edge.npz")
    art = api.load("model.edge.npz")              # verifies per-plane CRCs
    eng = art.engine(quality="mid", batch_slots=8, device="cuda")
    rid = eng.submit([1, 2, 3], max_new=16, quality="lo")
    eng.run_until_drained()

The npz artifact is the JAX package's format: either package loads the
other's files.
"""
from repro_torch.quant.artifact import (
    DEFAULT_TIERS,
    ArtifactIntegrityError,
    EdgeArtifact,
    QualitySpec,
    QualityTier,
    compress,
    default_policy,
)
from repro_torch.serve import (
    AdmissionPolicy,
    FinishReason,
    QualityShed,
    RequestStatus,
    SLOBudget,
    SpecConfig,
    SubmitRejected,
)

load = EdgeArtifact.load

__all__ = [
    "DEFAULT_TIERS",
    "AdmissionPolicy",
    "ArtifactIntegrityError",
    "EdgeArtifact",
    "FinishReason",
    "QualitySpec",
    "QualityShed",
    "QualityTier",
    "RequestStatus",
    "SLOBudget",
    "SpecConfig",
    "SubmitRejected",
    "compress",
    "default_policy",
    "load",
]
