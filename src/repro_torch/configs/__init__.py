"""Architecture configs (--arch <id>) and the dry run's shapes for the port."""
from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    HybridConfig,
    MoEConfig,
    ShapeConfig,
    cell_is_supported,
    get_arch,
)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "HybridConfig", "MoEConfig", "ShapeConfig",
           "cell_is_supported", "get_arch"]
