"""QSQ core of the port: quantizer (Eq. 5-10), codec (Table II), CSD
multipliers, the energy model and the quantization policy."""
from repro_torch.core import codec, csd, energy
from repro_torch.core.policy import QuantPolicy, budgeted_policy, sensitivity_rank
from repro_torch.core.qsq import (
    LEVEL_TABLE,
    QSQConfig,
    QSQTensor,
    bits_per_code,
    codes_to_levels,
    dequantize,
    exhaustive_threshold_search,
    levels_for_phi,
    levels_to_codes,
    quantization_error,
    quantize,
    theta_levels,
    zeros_fraction,
)

__all__ = [
    "QSQConfig", "QSQTensor", "quantize", "dequantize", "quantization_error",
    "zeros_fraction", "levels_for_phi", "bits_per_code", "theta_levels", "levels_to_codes",
    "codes_to_levels", "exhaustive_threshold_search", "LEVEL_TABLE",
    "codec", "csd", "energy", "QuantPolicy", "sensitivity_rank", "budgeted_policy",
]
