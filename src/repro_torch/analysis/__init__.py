"""Run-time checks of the port (the counterpart of ``repro.analysis``'s
``retrace`` module)."""
from repro_torch.analysis.retrace import no_recapture

__all__ = ["no_recapture"]
