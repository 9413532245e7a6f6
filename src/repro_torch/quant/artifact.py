"""EdgeArtifact: compress -> save -> load -> engine (the port of
``repro/quant/artifact.py``).

The npz layout is the JAX package's: the flat wire keys (``jax``'s
keystr form, e.g. ``['blocks']['attn']['wq']['packed']``) plus one
``__edge_meta__`` JSON entry (arch config, tier spec, sensitivity ranking,
per-plane CRCs).  Both packages load each other's files.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import warnings
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, HybridConfig, MoEConfig
from repro_torch.core import codec
from repro_torch.core.policy import QuantPolicy, budgeted_policy
from repro_torch.core.qsq import QSQConfig
from repro_torch.quant.store import (
    QSQWeight,
    dense_tree,
    is_store,
    is_wire_leaf,
    max_level_delta,
    packable_leaf,
    plane_mask_for_drop,
    quantize_tree,
    tree_from_wire,
    tree_to_wire,
    truncate_tree,
)
from repro_torch.tree import keystr, path_str, tree_leaves_with_path

META_KEY = "__edge_meta__"
FORMAT = "edge-artifact-v1"
N_PLANES = 3  # 3-bit wire: sign/MSB, mid, LSB

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


class ArtifactIntegrityError(ValueError):
    """Checksum verification found damage no quality tier can absorb."""


# --------------------------------------------------------------------------
# Quality tiers
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QualityTier:
    """``drop_planes`` LSB code planes dropped from the least-sensitive
    ``drop_frac`` fraction of the artifact's packable matmul weights."""

    name: str
    drop_planes: int = 0
    drop_frac: float = 1.0

    def max_error_levels(self) -> int:
        """Per-weight error bound of this tier, in level units (x alpha)."""
        return max_level_delta(self.drop_planes)


@dataclasses.dataclass(frozen=True)
class QualitySpec:
    """The named tiers one artifact can serve, best quality first."""

    tiers: tuple[QualityTier, ...]

    def names(self) -> list[str]:
        return [t.name for t in self.tiers]

    def get(self, name: str) -> QualityTier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"unknown quality tier {name!r}; this artifact has {self.names()}")


DEFAULT_TIERS = QualitySpec((
    QualityTier("hi", drop_planes=0, drop_frac=0.0),
    QualityTier("mid", drop_planes=1, drop_frac=0.5),
    QualityTier("lo", drop_planes=1, drop_frac=1.0),
))


# --------------------------------------------------------------------------
# ArchConfig <-> JSON
# --------------------------------------------------------------------------
def _arch_to_json(cfg: ArchConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = _DTYPE_NAMES[cfg.dtype]
    return d


def _arch_from_json(d: dict) -> ArchConfig:
    known = {f.name for f in dataclasses.fields(ArchConfig)}
    d = {k: v for k, v in d.items() if k in known}
    d["dtype"] = getattr(torch, d["dtype"])
    if d.get("moe"):
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("hybrid"):
        d["hybrid"] = HybridConfig(**d["hybrid"])
    return ArchConfig(**d)


# --------------------------------------------------------------------------
# npz wire codec
# --------------------------------------------------------------------------
_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def flatten_keystr(tree) -> dict:
    """Wire tree -> {keystr path: numpy leaf} (npz-ready)."""
    return {keystr(p): np.asarray(leaf) for p, leaf in tree_leaves_with_path(tree)}


def atomic_savez(flat: dict, path: str | Path) -> Path:
    """Write an npz via tmp-file + rename, so a crashed writer never
    corrupts an existing file (artifacts and checkpoints alike)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    tmp.rename(path)
    return path


def save_wire_npz(wire, path: str | Path, meta: dict | None = None) -> Path:
    """Atomically write a wire tree (plus optional JSON meta) as npz."""
    flat = flatten_keystr(wire)
    if meta is not None:
        flat[META_KEY] = np.array(json.dumps(meta))
    return atomic_savez(flat, path)


def load_wire_npz(path: str | Path) -> tuple[Any, dict | None]:
    """Inverse of :func:`save_wire_npz` -> (nested wire tree, meta or None)."""
    meta = None
    root: dict = {}
    with np.load(Path(path), allow_pickle=False) as data:
        for key in data.files:
            if key == META_KEY:
                meta = json.loads(str(data[key][()]))
                continue
            parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
                     for m in _KEY_RE.finditer(key)]
            if not parts:
                continue
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]

    def _listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: _listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in sorted(out)]
        return out

    return _listify(root), meta


# --------------------------------------------------------------------------
# The artifact
# --------------------------------------------------------------------------
@dataclasses.dataclass
class EdgeArtifact:
    """A quality-dialed compressed model: wire tree + tiers + arch identity."""

    wire: Any
    arch_config: ArchConfig | None = None
    tiers: QualitySpec = DEFAULT_TIERS
    rank: tuple = ()  # ((path, sensitivity_score), ...) most sensitive first
    policy_meta: dict = dataclasses.field(default_factory=dict)
    plane_damage: dict = dataclasses.field(default_factory=dict)

    @property
    def arch(self) -> str:
        return self.arch_config.name if self.arch_config is not None else ""

    def model(self):
        if self.arch_config is None:
            raise ValueError("this artifact carries no arch config")
        from repro_torch.models.api import Model  # deferred: models -> quant cycle

        return Model(self.arch_config)

    def quality_names(self) -> list[str]:
        return self.tiers.names()

    # -- tier resolution --------------------------------------------------
    def drop_map(self, quality: str) -> dict[str, int]:
        """Tier name -> {path: LSB planes to drop}, least sensitive first."""
        tier = self.tiers.get(quality)
        if tier.drop_planes <= 0 or tier.drop_frac <= 0:
            return {}
        if not self.rank:
            raise ValueError(
                f"quality tier {quality!r} needs a sensitivity ranking to pick "
                f"truncation targets, but this artifact has none")
        paths = [p for p, _ in self.rank]
        n_aff = min(len(paths), max(1, math.ceil(tier.drop_frac * len(paths))))
        return {p: tier.drop_planes for p in paths[len(paths) - n_aff:]}

    def tier_drop_vectors(self) -> dict[str, tuple[int, ...]]:
        """Path -> per-tier plane-drop vector over every truncated path."""
        n = len(self.tiers.tiers)
        out: dict[str, list[int]] = {}
        for i, tier in enumerate(self.tiers.tiers):
            for p, d in self.drop_map(tier.name).items():
                out.setdefault(p, [0] * n)[i] = int(d)
        return {p: tuple(v) for p, v in out.items()}

    # -- per-plane integrity ----------------------------------------------
    def _wire_leaves(self) -> list[tuple[str, dict]]:
        return [(path_str(p), leaf)
                for p, leaf in tree_leaves_with_path(self.wire, is_leaf=is_wire_leaf)
                if is_wire_leaf(leaf)]

    @staticmethod
    def _leaf_codes(leaf: dict) -> np.ndarray:
        n = int(np.prod(np.asarray(leaf["shape"]).reshape(-1)))
        words = torch.from_numpy(np.array(leaf["packed"], dtype=np.int32))
        return codec.unpack_dense(words, n).numpy()

    def plane_integrity(self) -> dict[str, list[int]]:
        """Path -> per-plane CRC32s (MSB first) of each wire leaf's codes."""
        return {p: list(codec.plane_crcs(self._leaf_codes(leaf)))
                for p, leaf in self._wire_leaves()}

    def _verify_integrity(self, stored: dict) -> None:
        """Check every wire leaf's per-plane CRCs; zero damaged trailing LSB
        planes in place (recorded in ``plane_damage``), raise on damage to
        the sign/MSB plane."""
        damage: dict[str, int] = {}
        for p, leaf in self._wire_leaves():
            want = stored.get(p)
            if want is None:
                continue
            codes = self._leaf_codes(leaf)
            got = codec.plane_crcs(codes)
            bad = [i for i in range(N_PLANES) if got[i] != int(want[i]) & 0xFFFFFFFF]
            if not bad:
                continue
            if 0 in bad:
                raise ArtifactIntegrityError(
                    f"wire leaf {p!r}: sign/MSB plane failed its checksum "
                    f"— unrecoverable; re-download the artifact")
            need = max(N_PLANES - i for i in bad)
            repaired = codes & np.uint8(plane_mask_for_drop(need))
            leaf["packed"] = codec.pack_dense(torch.from_numpy(repaired), bits=3).numpy()
            damage[p] = need
        self.plane_damage = damage

    def tier_ceiling_index(self) -> int:
        """Best tier index this artifact can still serve (0 when pristine)."""
        if not self.plane_damage:
            return 0
        for t, tier in enumerate(self.tiers.tiers):
            dm = self.drop_map(tier.name)
            if all(dm.get(p, 0) >= need for p, need in self.plane_damage.items()):
                return t
        raise ArtifactIntegrityError(
            f"plane damage {self.plane_damage} exceeds every quality tier's "
            f"truncation ({self.quality_names()}); the artifact cannot be served "
            f"— re-download")

    def degraded_quality(self, quality: str) -> tuple[str, int]:
        ceiling = self.tier_ceiling_index()
        names = self.quality_names()
        if names.index(quality) < ceiling:
            warnings.warn(
                f"artifact plane damage {self.plane_damage} caps serving at tier "
                f"{names[ceiling]!r}; requested {quality!r} is degraded to it",
                stacklevel=3)
            quality = names[ceiling]
        return quality, ceiling

    # -- realization ------------------------------------------------------
    def tree(self, device="cuda"):
        """Decode the wire to a WeightStore tree (QSQWeight leaves) on ``device``
        (the card unless the caller asks for the CPU)."""
        from repro_torch.models.base import resolve_device

        return tree_from_wire(self.wire, resolve_device(device))

    def dense_params(self, quality: str = "hi", like=None, device="cuda"):
        """Fully decoded param tree at a tier on ``device`` (``like``: a
        matching tree giving dtypes).  Plane-damaged artifacts clamp
        ``quality`` to the tier ceiling."""
        if self.plane_damage:
            quality, _ = self.degraded_quality(quality)
        return dense_tree(truncate_tree(self.tree(device), self.drop_map(quality)), like=like)

    def serve_params(self, quality: str = "hi", packed: bool = True,
                     per_request: bool = False, device="cuda"):
        """(params, n_packed) at a tier on ``device`` — matmul weights stay
        bit-planes.  ``per_request`` keeps full-quality planes and stamps
        every tier-affected leaf with its drop vector."""
        if per_request:
            self.tiers.get(quality)  # validate the default tier name
            return self.model().serve_params(
                self.wire, packed=True, tier_drop_map=self.tier_drop_vectors(),
                device=device)
        return self.model().serve_params(self.wire, packed=packed,
                                         drop_map=self.drop_map(quality), device=device)

    def _per_request_capable(self, cfg) -> bool:
        """True when an engine under ``cfg`` can serve per-request tiers:
        packed continuous greedy serving of an attention family, with a
        sensitivity ranking (or a tier spec that never drops)."""
        from repro_torch.train.step import supports_fused_prefill

        if not (cfg.packed and cfg.continuous and cfg.temperature == 0):
            return False
        if self.arch_config is None or not supports_fused_prefill(self.model()):
            return False
        drops_any = any(t.drop_planes > 0 and t.drop_frac > 0 for t in self.tiers.tiers)
        return bool(self.rank) or not drops_any

    def engine(self, quality: str = "hi", serve_cfg=None,
               per_request: bool | None = None, device="cuda", eager: bool = False,
               **serve_kw):
        """Build a ServeEngine on ``device`` at a named tier; per-request
        quality is on whenever the config can serve it.  ``eager`` runs the
        continuous steps eagerly instead of as CUDA graphs."""
        from repro_torch.serve.engine import ServeConfig, ServeEngine

        if serve_cfg is not None and serve_kw:
            raise TypeError(f"pass either serve_cfg or ServeConfig kwargs, not both "
                            f"(got serve_cfg and {sorted(serve_kw)})")
        cfg = serve_cfg if serve_cfg is not None else ServeConfig(**serve_kw)
        if per_request is None:
            per_request = self._per_request_capable(cfg)
        elif per_request and not self._per_request_capable(cfg):
            raise ValueError(
                "per-request quality needs packed continuous greedy serving of an "
                "attention family, from an artifact with a sensitivity ranking")
        ceiling = 0
        if self.plane_damage:
            quality, ceiling = self.degraded_quality(quality)
        from repro_torch.models.base import resolve_device

        device = resolve_device(device)
        params, n_packed = self.serve_params(quality, packed=cfg.packed,
                                             per_request=per_request, device=device)
        eng = ServeEngine(self.model(), params, cfg, device=device, eager=eager)
        eng.n_packed_leaves = n_packed
        eng.artifact = self
        eng.quality = quality
        if per_request:
            eng.tier_names = self.quality_names()
            eng.tier_ceiling = ceiling
        return eng

    # -- persistence ------------------------------------------------------
    def save(self, path: str | Path) -> Path:
        """Write the self-describing artifact npz."""
        meta = {
            "format": FORMAT,
            "arch": _arch_to_json(self.arch_config) if self.arch_config is not None else None,
            "tiers": [dataclasses.asdict(t) for t in self.tiers.tiers],
            "rank": [[p, float(s)] for p, s in self.rank],
            "policy": self.policy_meta,
            "integrity": self.plane_integrity(),
        }
        return save_wire_npz(self.wire, path, meta)

    @classmethod
    def load(cls, path: str | Path, verify: bool = True) -> "EdgeArtifact":
        """Read an artifact npz; with ``verify``, check the per-plane CRCs."""
        wire, meta = load_wire_npz(path)
        if meta is None:
            return cls(wire=wire)
        art = cls(
            wire=wire,
            arch_config=_arch_from_json(meta["arch"]) if meta.get("arch") else None,
            tiers=QualitySpec(tuple(QualityTier(**t) for t in meta["tiers"]))
            if meta.get("tiers") else DEFAULT_TIERS,
            rank=tuple((p, s) for p, s in meta.get("rank", [])),
            policy_meta=meta.get("policy", {}),
        )
        if verify and meta.get("integrity"):
            art._verify_integrity(meta["integrity"])
        return art


# --------------------------------------------------------------------------
# compress
# --------------------------------------------------------------------------
def default_policy() -> QuantPolicy:
    """Contraction-grouped 3-bit QSQ with the alpha refit."""
    return QuantPolicy(base=QSQConfig(group_size=16, refit_alpha=True), min_numel=512)


def _proxy_rank(params, store, descs) -> list[tuple[str, float]]:
    """Data-free sensitivity proxy: relative quantization error per leaf
    (packable leaves when descriptors are given), most sensitive first."""
    flat_p = {path_str(p): leaf for p, leaf in tree_leaves_with_path(params)}
    desc_map = {}
    if descs is not None:
        desc_map = {path_str(p): d for p, d in tree_leaves_with_path(descs)}
    scores = []
    for p, leaf in tree_leaves_with_path(store, is_leaf=is_store):
        ps = path_str(p)
        if not isinstance(leaf, QSQWeight):
            continue
        if descs is not None and not packable_leaf(ps, leaf, desc_map.get(ps)):
            continue
        w = flat_p[ps].to(torch.float32)
        err = leaf.as_dense(torch.float32) - w
        scores.append((ps, float(torch.sum(err * err) / (torch.sum(w * w) + 1e-12))))
    return sorted(scores, key=lambda t: -t[1])


def compress(model, params, policy: QuantPolicy | None = None,
             tiers: QualitySpec = DEFAULT_TIERS,
             sensitivity: Sequence[tuple[str, float]] | None = None,
             device="cuda") -> EdgeArtifact:
    """Quantize a model once on ``device`` and return the EdgeArtifact.

    ``sensitivity`` is an optional calibration ranking from
    ``core.policy.sensitivity_rank`` (most sensitive first).  When given it
    is folded into the policy as per-layer phi overrides
    (``budgeted_policy``) and it orders the tier truncation; without it the
    data-free proxy ranking orders the tiers.
    """
    from repro_torch.models.base import resolve_device
    from repro_torch.tree import tree_map

    device = resolve_device(device)
    policy = policy if policy is not None else default_policy()
    if sensitivity:
        policy = budgeted_policy(list(sensitivity), policy)
    params = tree_map(lambda a: torch.as_tensor(a).to(device), params)
    descs = model.param_descs() if model is not None else None
    store = quantize_tree(params, policy, descs)
    rank = (tuple((p, float(s)) for p, s in sensitivity) if sensitivity
            else tuple(_proxy_rank(params, store, descs)))
    return EdgeArtifact(
        wire=tree_to_wire(store),
        arch_config=model.cfg if model is not None else None,
        tiers=tiers,
        rank=rank,
        policy_meta={
            "phi": policy.base.phi,
            "group_size": policy.base.group_size,
            "assign": policy.base.assign,
            "refit_alpha": policy.base.refit_alpha,
            "n_overrides": len(policy.overrides),
            "calibrated": bool(sensitivity),
        },
    )
