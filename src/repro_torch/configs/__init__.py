"""Architecture configs (--arch <id>) for the port."""
from repro_torch.configs.base import ARCH_IDS, ArchConfig, HybridConfig, MoEConfig, get_arch

__all__ = ["ARCH_IDS", "ArchConfig", "HybridConfig", "MoEConfig", "get_arch"]
