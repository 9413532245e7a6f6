"""Weight leaves of the port (the port of ``repro/quant/store.py``).

A parameter lives in one of three forms: a dense tensor, a
:class:`QSQWeight` (signed int8 levels + per-group f32 scales, the
transport form) or a :class:`PackedWeight` (3-bit bit-planes + scales,
the serving form the CUDA kernels consume).  Stacked layer leaves keep
their leading layer axis; :meth:`PackedWeight.layer` slices one layer off
for the layer loop.

Tree helpers quantize a parameter tree under a :class:`QuantPolicy`
(grouping along the true contraction axis when descriptors are given),
convert to and from the 3-bit wire form (numpy arrays, the npz payload the
JAX package reads and writes too), and build serving trees that keep
kernel-eligible weights packed.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qsq import (
    QSQTensor,
    _quantize_impl,
    codes_to_levels,
    levels_to_codes,
    levels_to_smcodes,
    quantize,
    smcodes_to_levels,
)
from repro_torch.tree import path_str, tree_leaves, tree_map, tree_map_with_path

# Logical axes a 2-D-view matmul contracts over, and path fragments never
# served packed (attention wo is excluded by the stack-prefix rule).
CONTRACT_AXES = ("embed", "mlp", "heads_inner")
STACK_AXES = ("layers", None)
EXCLUDE_PATHS = ("tok", "router", "conv", "norm", "a_log", "dt_bias")


def _is_desc(x) -> bool:
    return hasattr(x, "axes") and hasattr(x, "shape") and hasattr(x, "dtype")


def contract_idx(desc) -> int | None:
    """Index of the first contraction axis in a ParamDesc, else None."""
    for i, name in enumerate(desc.axes):
        if name in CONTRACT_AXES:
            return i
    return None


def kernel_eligible(path: str, desc) -> bool:
    """True if this param can be served as bit-planes: its contraction axis
    leads (after scan-stack axes only) and is a multiple of 32."""
    if any(e in path for e in EXCLUDE_PATHS):
        return False
    idx = contract_idx(desc)
    if idx is None:
        return False
    if any(a not in STACK_AXES for a in desc.axes[:idx]):
        return False
    return desc.shape[idx] % codec.PLANE_GROUP == 0


def _conv_view(leaf: torch.Tensor) -> torch.Tensor:
    """(kh, kw, cin, cout) -> channel-major view (cin, kh*kw*cout)."""
    w = torch.movedim(leaf, 2, 0)
    return w.reshape(w.shape[0], -1)


def _conv_unview(levels_like: torch.Tensor, conv_shape) -> torch.Tensor:
    kh, kw, cin, cout = conv_shape
    return torch.movedim(levels_like.reshape(cin, kh, kw, cout), 0, 2)


# --------------------------------------------------------------------------
# LSB plane truncation: a lower tier zeroes the least-significant code
# bit-planes of the already-quantized codes, never re-quantizes.
# --------------------------------------------------------------------------
def _trunc_code_mask(drop: int) -> int:
    if not 0 <= drop < 3:
        raise ValueError(f"drop must be 0, 1 or 2; got {drop}")
    return (~((1 << drop) - 1)) & 0x7


def plane_mask_for_drop(drop: int) -> int:
    """``drop`` LSB planes -> the 3-bit code mask (MASK_VARIANTS[drop])."""
    return _trunc_code_mask(drop)


# --------------------------------------------------------------------------
# Leaf representations
# --------------------------------------------------------------------------
class WeightStore:
    """Marks the quantized leaf forms (anything else in a tree is a tensor);
    each can decode itself with ``as_dense(dtype)``."""


def is_store(x) -> bool:
    return isinstance(x, WeightStore)


@dataclasses.dataclass
class QSQWeight(QSQTensor, WeightStore):
    """QSQ levels + scales grouped along axis ``ndim - 1 - rest_ndim``;
    leading axes before it are layer stacks."""

    rest_ndim: int | None = None

    @classmethod
    def from_tensor(cls, q: QSQTensor, rest_ndim: int | None = None):
        return cls(levels=q.levels, scales=q.scales, group_size=q.group_size,
                   phi=q.phi, conv_shape=q.conv_shape, rest_ndim=rest_ndim)

    def _rest(self) -> int:
        return self.rest_ndim if self.rest_ndim is not None else self.levels.dim() - 1

    def _stack(self) -> int:
        return self.levels.dim() - 1 - self._rest()

    def as_dense(self, dtype=torch.float32) -> torch.Tensor:
        st = self._stack()
        shape = tuple(self.levels.shape)
        ng = self.scales.shape[st]
        g = shape[st] // max(ng, 1)
        lev = self.levels.to(torch.float32).reshape(shape[:st] + (ng, g) + shape[st + 1:])
        w = (lev * self.scales.unsqueeze(st + 1)).reshape(shape)
        if self.conv_shape is not None:
            w = _conv_unview(w, self.conv_shape)
        return w.to(dtype)

    def truncate(self, drop: int) -> "QSQWeight":
        """Level-space LSB plane truncation: each level through its
        sign-magnitude code with the ``drop`` lowest bits zeroed — the same
        levels as ``pack().truncate(drop)``, for any grouping.  Scales are
        kept; nothing is re-quantized."""
        if drop == 0:
            return self
        mask = _trunc_code_mask(drop)
        return dataclasses.replace(
            self, levels=smcodes_to_levels(levels_to_smcodes(self.levels) & mask))

    def pack(self, sign_mag: bool = True) -> "PackedWeight":
        """-> bit-plane form (*stack, K//32, 3, *rest); K must be 32-aligned."""
        if self.conv_shape is not None:
            raise ValueError("conv-view QSQ weights are not kernel-servable")
        st = self._stack()
        codes = (levels_to_smcodes if sign_mag else levels_to_codes)(self.levels)
        planes = codec.pack_bitplane(torch.movedim(codes, st, 0))  # (K//32, 3, *stack, *rest)
        planes = torch.movedim(planes, (0, 1), (st, st + 1)).contiguous()
        return PackedWeight(planes=planes, scales=self.scales.contiguous(),
                            group_size=self.group_size, phi=self.phi,
                            rest_ndim=self._rest(), sign_mag=sign_mag)


_MASKS: dict = {}  # (tier_drops, device) -> per-tier code-mask tensor


@dataclasses.dataclass
class PackedWeight(WeightStore):
    """Bit-plane packed 3-bit codes + per-group scalars — the serving form.

    planes: (*stack, K//32, 3, *rest) int32 — or (*stack, 3, K//32, *rest)
    MSB-first when ``plane_major`` — and scales (*stack, K//G, *rest) f32.
    ``n_planes`` counts the significant planes (3 = full quality);
    ``tier_drops`` (entry t = LSB planes tier t drops from this weight)
    drives per-row plane masks at matmul time; ``sign_mag`` marks
    sign-magnitude codes.
    """

    planes: torch.Tensor
    scales: torch.Tensor
    group_size: int
    phi: int
    rest_ndim: int = 0
    n_planes: int = 3
    tier_drops: tuple[int, ...] | None = None
    sign_mag: bool = False
    plane_major: bool = False

    def _stack(self) -> int:
        return self.planes.dim() - 2 - self.rest_ndim

    @property
    def shape(self):
        """Logical dense shape."""
        st = self._stack()
        k_axis = st + 1 if self.plane_major else st
        k = self.planes.shape[k_axis] * codec.PLANE_GROUP
        return tuple(self.planes.shape[:st]) + (k,) + tuple(self.planes.shape[st + 2:])

    def layer(self, i: int) -> "PackedWeight":
        """Layer ``i`` of a stacked leaf (a view; no copy)."""
        if not self._stack():
            raise ValueError("layer() on an unstacked PackedWeight")
        return dataclasses.replace(self, planes=self.planes[i], scales=self.scales[i])

    def to_plane_major(self) -> "PackedWeight":
        """-> plane axis before K//32, MSB first (lossless; idempotent)."""
        if self.plane_major:
            return self
        st = self._stack()
        pm = torch.flip(torch.movedim(self.planes, st + 1, st), dims=(st,)).contiguous()
        return dataclasses.replace(self, planes=pm, plane_major=True)

    def truncate(self, drop: int) -> "PackedWeight":
        """Zero the ``drop`` LSB bit-planes (counted from full quality)."""
        if drop == 0:
            return self
        if not 0 < drop < 3:
            raise ValueError(f"drop must be 0, 1 or 2; got {drop}")
        st = self._stack()
        if self.plane_major:
            idx = (slice(None),) * st + (slice(3 - drop, 3),)
        else:
            idx = (slice(None),) * (st + 1) + (slice(0, drop),)
        planes = self.planes.clone()
        planes[idx] = 0
        return dataclasses.replace(self, planes=planes,
                                   n_planes=min(self.n_planes, 3 - drop))

    def unpack(self) -> QSQWeight:
        st = self._stack()
        front = torch.movedim(self.planes, (st, st + 1), (0, 1))
        codes = (codec.unpack_bitplane_major(front) if self.plane_major
                 else codec.unpack_bitplane(front))
        to_levels = smcodes_to_levels if self.sign_mag else codes_to_levels
        return QSQWeight(levels=torch.movedim(to_levels(codes), 0, st), scales=self.scales,
                         group_size=self.group_size, phi=self.phi,
                         rest_ndim=self.rest_ndim)

    def as_dense(self, dtype=torch.float32):
        return self.unpack().as_dense(dtype)

    def tier_plane_masks(self) -> torch.Tensor | None:
        """Per-tier 3-bit code masks (None when no tier drops a plane);
        index with per-slot tiers for the per-row ``plane_mask``."""
        if not self.tier_drops or not any(self.tier_drops):
            return None
        key = (self.tier_drops, str(self.planes.device))
        masks = _MASKS.get(key)
        if masks is None:
            masks = torch.tensor([_trunc_code_mask(d) for d in self.tier_drops],
                                 dtype=torch.int32, device=self.planes.device)
            _MASKS[key] = masks
        return masks

    def demand_drop(self, demand_tier: int | None = None) -> int:
        """Static plane-drop floor for a batch whose minimum live tier index
        is ``demand_tier`` (see the JAX package's ``demand_drop``)."""
        drop = 0
        if demand_tier is not None and self.tier_drops:
            t = min(max(int(demand_tier), 0), len(self.tier_drops) - 1)
            drop = min(self.tier_drops[t:])
        if self.plane_major:
            drop = max(drop, 3 - self.n_planes)
        return int(drop)

    def matmul(self, x: torch.Tensor, plane_mask: torch.Tensor | None = None,
               demand_tier: int | None = None) -> torch.Tensor:
        """Contract x (..., K) with this weight; ``plane_mask`` (a leading
        prefix of x's lead dims) tiers it per row, ``demand_tier`` bounds the
        planes any row wants."""
        if self._stack():
            raise ValueError("matmul on a stacked PackedWeight — take .layer(i) first")
        rest = tuple(self.planes.shape[2:])
        k_words = self.planes.shape[1 if self.plane_major else 0]
        k = k_words * codec.PLANE_GROUP
        if x.shape[-1] != k:
            raise ValueError(f"x last dim {x.shape[-1]} != K {k}")
        n = int(np.prod(rest)) if rest else 1
        ng = self.scales.shape[0]
        lead = tuple(x.shape[:-1])
        m = int(np.prod(lead)) if lead else 1
        if plane_mask is not None:
            pm = plane_mask.to(torch.int32)
            if pm.dim() > len(lead) or tuple(pm.shape) != lead[: pm.dim()]:
                raise ValueError(f"plane_mask shape {tuple(pm.shape)} is not a leading "
                                 f"prefix of x lead dims {lead}")
            pm = pm.reshape(tuple(pm.shape) + (1,) * (len(lead) - pm.dim()))
            plane_mask = pm.expand(lead if lead else (1,)).reshape(m).contiguous()

        from repro_torch.kernels import dispatch  # deferred: kernels off cold paths

        pshape = (3, k_words, n) if self.plane_major else (k_words, 3, n)
        out = dispatch.packed_matmul(
            x.reshape(m, k).contiguous(), self.planes.reshape(pshape),
            self.scales.reshape(ng, n), group_size=k // ng, plane_mask=plane_mask,
            sign_mag=self.sign_mag, plane_major=self.plane_major,
            demand_drop=self.demand_drop(demand_tier))
        return out.to(x.dtype).reshape(*lead, *rest)

    def nbits(self) -> int:
        kept_plane_words = (self.planes.numel() // 3) * self.n_planes
        return int(32 * (kept_plane_words + self.scales.numel()))


# --------------------------------------------------------------------------
# Tree level
# --------------------------------------------------------------------------
def quantize_tree(params, policy: QuantPolicy, descs=None):
    """Quantize selected leaves of a parameter tree -> QSQWeight leaves.

    With ``descs``, kernel-eligible matmul weights are grouped along their
    contraction axis (leading stack axes independent); other selected
    leaves keep axis-0 grouping, and 4-D leaves the channel-major view.
    """

    def _eligible_leaf(path, leaf, desc):
        idx = contract_idx(desc)
        cfg = policy.config_for(path, tuple(leaf.shape[idx:]))
        if cfg is None:
            return leaf
        levels, scales = _quantize_impl(
            leaf, phi=cfg.phi, group_size=cfg.group_size, assign=cfg.assign,
            delta=cfg.delta, gamma_frac=cfg.gamma_frac, refit_alpha=cfg.refit_alpha,
            axis=idx)
        return QSQWeight(levels=levels, scales=scales, group_size=cfg.group_size,
                         phi=cfg.phi, rest_ndim=leaf.dim() - idx - 1)

    def _legacy_leaf(path, leaf):
        view = _conv_view(leaf) if leaf.dim() == 4 else leaf
        cfg = policy.config_for(path, tuple(view.shape))
        if cfg is None:
            return leaf
        q = quantize(view, cfg)
        if leaf.dim() == 4:
            q = dataclasses.replace(q, conv_shape=tuple(leaf.shape))
        return QSQWeight.from_tensor(q, rest_ndim=q.levels.dim() - 1)

    if descs is None:
        return tree_map_with_path(lambda p, a: _legacy_leaf(path_str(p), a), params)

    def _leaf(path, leaf, desc):
        p = path_str(path)
        if _is_desc(desc) and kernel_eligible(p, desc):
            return _eligible_leaf(p, leaf, desc)
        return _legacy_leaf(p, leaf)

    return tree_map_with_path(_leaf, params, descs)


def packable_leaf(path: str, leaf, desc) -> bool:
    """True if this QSQ leaf can be served as bit-planes through the kernels."""
    return (
        isinstance(leaf, QSQWeight)
        and leaf.conv_shape is None
        and _is_desc(desc)
        and kernel_eligible(path, desc)
        and leaf._rest() == len(desc.shape) - contract_idx(desc) - 1
        and leaf.levels.shape[contract_idx(desc)] % codec.PLANE_GROUP == 0
    )


def serve_tree(tree, descs, dtype=None, drop_map=None, tier_drop_map=None):
    """Serving layout: pack kernel-eligible QSQ leaves (sign-magnitude,
    plane-major), decode the rest once.  Returns (params_tree, n_packed)."""
    n_packed = 0
    drop_map = drop_map or {}
    tier_drop_map = tier_drop_map or {}

    def _leaf(path, leaf, desc):
        nonlocal n_packed
        if not is_store(leaf):
            return leaf
        p = path_str(path)
        if packable_leaf(p, leaf, desc):
            n_packed += 1
            pw = leaf.pack().truncate(drop_map.get(p, 0)).to_plane_major()
            if p in tier_drop_map:
                pw = dataclasses.replace(
                    pw, tier_drops=tuple(int(d) for d in tier_drop_map[p]))
            return pw
        if p in drop_map and isinstance(leaf, QSQWeight):
            leaf = leaf.truncate(drop_map[p])
        return leaf.as_dense(dtype if dtype is not None else desc.dtype)

    out = tree_map_with_path(_leaf, tree, descs, is_leaf=is_store)
    return out, n_packed


def truncate_tree(tree, drop_map: dict):
    """Per-path LSB plane truncation of the QSQ/packed leaves ``drop_map``
    names ('/'-joined path -> planes to drop, from full quality)."""

    def _leaf(path, leaf):
        drop = drop_map.get(path_str(path), 0)
        if drop and isinstance(leaf, (QSQWeight, PackedWeight)):
            return leaf.truncate(drop)
        return leaf

    return tree_map_with_path(_leaf, tree, is_leaf=is_store)


def dense_tree(tree, like=None):
    """Decode every WeightStore leaf to dense; ``like`` (a matching tree of
    tensors or ParamDescs) gives the target dtypes, f32 otherwise."""

    def _leaf(leaf, ref=None):
        if not is_store(leaf):
            return leaf
        return leaf.as_dense(ref.dtype if ref is not None else torch.float32)

    if like is None:
        return tree_map(_leaf, tree, is_leaf=is_store)
    return tree_map(_leaf, tree, like, is_leaf=is_store)


def tree_bits_report(tree) -> dict:
    """Eq. 11/12 accounting over a mixed-representation tree (stored bits
    against the tree held as f32)."""
    total_bits = dense_bits = n_store = n_total = 0
    for leaf in tree_leaves(tree, is_leaf=is_store):
        n_total += 1
        if is_store(leaf):
            n_store += 1
            total_bits += leaf.nbits()
            dense_bits += int(8 * 4 * np.prod(leaf.shape))
        else:
            b = int(8 * leaf.numel() * leaf.element_size())
            total_bits += b
            dense_bits += b
    return {"bits": total_bits, "dense_bits": dense_bits,
            "savings": 1.0 - total_bits / max(dense_bits, 1),
            "n_store_leaves": n_store, "n_leaves": n_total}


# --------------------------------------------------------------------------
# Wire form: QSQWeight <-> {packed int32 words, scales, meta} dict of numpy
# arrays — the npz payload both packages read and write.
# --------------------------------------------------------------------------
WIRE_FLAG = "__qsq__"
# 1 = Table II offset codes (legacy, implied when absent), 2 = sign-magnitude
WIRE_CODE_FMT = 2


def is_wire_leaf(x) -> bool:
    return isinstance(x, dict) and bool(x.get(WIRE_FLAG, False))


def wire_encode_leaf(q: QSQTensor) -> dict:
    """Any QSQTensor/QSQWeight -> the dense-packed 3-bit wire dict (v2)."""
    codes = levels_to_smcodes(q.levels).reshape(-1)
    rest = (q.rest_ndim if isinstance(q, QSQWeight) and q.rest_ndim is not None
            else q.levels.dim() - 1)
    return {
        WIRE_FLAG: True,
        "packed": codec.pack_dense(codes, bits=3).cpu().numpy(),
        "scales": q.scales.to(torch.float32).cpu().numpy(),
        "shape": tuple(int(s) for s in q.levels.shape),
        "group_size": int(q.group_size),
        "phi": int(q.phi),
        "rest_ndim": int(rest),
        "conv_shape": tuple(int(s) for s in q.conv_shape) if q.conv_shape else (),
        "code_fmt": WIRE_CODE_FMT,
    }


def wire_decode_leaf(d: dict, device="cpu") -> QSQWeight:
    """Inverse of :func:`wire_encode_leaf` (lossless), reading legacy v1
    (Table II, no ``code_fmt``) and npz-roundtripped metadata too."""
    shape = tuple(int(s) for s in np.asarray(d["shape"]).reshape(-1))
    n = int(np.prod(shape)) if shape else 1
    words = torch.from_numpy(np.array(d["packed"], dtype=np.int32)).to(device)
    codes = codec.unpack_dense(words, n).reshape(shape)
    conv = tuple(int(s) for s in np.asarray(d.get("conv_shape", ())).reshape(-1))
    rest = d.get("rest_ndim", None)
    fmt_raw = d.get("code_fmt", None)
    fmt = int(np.asarray(fmt_raw)) if fmt_raw is not None else 1
    if fmt not in (1, WIRE_CODE_FMT):
        raise ValueError(f"unknown wire code_fmt {fmt}")
    to_levels = smcodes_to_levels if fmt == WIRE_CODE_FMT else codes_to_levels
    return QSQWeight(
        levels=to_levels(codes),
        scales=torch.from_numpy(np.array(d["scales"], dtype=np.float32)).to(device),
        group_size=int(np.asarray(d["group_size"])),
        phi=int(np.asarray(d["phi"])),
        conv_shape=conv if conv else None,
        rest_ndim=int(np.asarray(rest)) if rest is not None else None,
    )


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()
    return x


def tree_to_wire(tree) -> Any:
    """Store tree -> wire tree of numpy arrays."""

    def _leaf(leaf):
        if isinstance(leaf, PackedWeight):
            return wire_encode_leaf(leaf.unpack())
        if isinstance(leaf, QSQTensor):
            return wire_encode_leaf(leaf)
        return _to_numpy(leaf)

    return tree_map(_leaf, tree, is_leaf=lambda x: is_store(x) or isinstance(x, QSQTensor))


def tree_from_wire(wire, device="cpu") -> Any:
    """Wire tree -> store tree with QSQWeight leaves, tensors on ``device``."""

    def _leaf(x):
        if is_wire_leaf(x):
            return wire_decode_leaf(x, device)
        return torch.from_numpy(np.array(x)).to(device)

    return tree_map(_leaf, wire, is_leaf=is_wire_leaf)
