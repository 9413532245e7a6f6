"""Applying QSQ to whole parameter trees: quantize / dequantize, the weight
stores, the packed serving form and the quality-dialed artifact."""
from repro_torch.quant.pytree import (
    QuantizedParams,
    dequantize_pytree,
    pack_pytree_wire,
    pytree_bits_report,
    quantize_pytree,
    unpack_pytree_wire,
)

__all__ = [
    "QuantizedParams",
    "quantize_pytree",
    "dequantize_pytree",
    "pytree_bits_report",
    "pack_pytree_wire",
    "unpack_pytree_wire",
]

from repro_torch.quant.store import (
    DenseWeight,
    PackedWeight,
    QSQWeight,
    WeightStore,
    dense_tree,
    is_store,
    max_level_delta,
    plane_mask_for_drop,
    quantize_tree,
    serve_tree,
    tree_bits_report,
    tree_from_wire,
    tree_to_wire,
    truncate_tree,
)

__all__ += [
    "WeightStore", "DenseWeight", "QSQWeight", "PackedWeight", "is_store",
    "quantize_tree", "dense_tree", "serve_tree", "tree_bits_report",
    "tree_to_wire", "tree_from_wire", "truncate_tree", "max_level_delta",
    "plane_mask_for_drop",
]

from repro_torch.quant.artifact import (
    DEFAULT_TIERS,
    EdgeArtifact,
    QualitySpec,
    QualityTier,
    compress,
)

__all__ += [
    "EdgeArtifact", "QualitySpec", "QualityTier", "DEFAULT_TIERS", "compress",
]
