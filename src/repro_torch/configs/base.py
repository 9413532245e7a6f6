"""Architecture and shape configuration schema and the --arch registry (the
port of ``repro/configs/base.py``).

The field set is the JAX package's; ``dtype`` is a ``torch.dtype``.
Artifacts store the JAX package's full field set, and
``quant.artifact._arch_from_json`` keeps the fields this class knows.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    period: int = 8
    moe_every: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    window: int | None = None  # sliding-window attention
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    hybrid: HybridConfig | None = None
    enc_layers: int = 0
    enc_seq: int = 1500
    cross_every: int = 0
    vision_tokens: int = 1024
    dtype: Any = torch.bfloat16
    remat: bool = True
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k decode shape?"""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_decode(self) -> bool:
        return self.family != "cnn"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = ["smollm_135m", "phi4_mini_3_8b", "qwen3_14b", "deepseek_7b", "qwen3_moe_30b_a3b",
            "mixtral_8x22b", "mamba2_1_3b", "jamba_1_5_large_398b", "llama_3_2_vision_11b",
            "whisper_tiny"]


def canonical(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    """Load configs/<id>.py and return CONFIG (or SMOKE_CONFIG)."""
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def cell_is_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(supported, reason-if-not) for an (arch x shape) cell."""
    if cfg.family == "cnn":
        return False, "cnn archs are trained directly; LM shapes do not apply"
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "no decode step for this family"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention; 500k decode skipped (DESIGN.md §4)"
    return True, ""
