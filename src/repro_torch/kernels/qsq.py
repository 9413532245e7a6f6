"""Wrappers of the five QSQ kernels: four packed matmuls and the encoder.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches its CUDA kernel
(``csrc/qsq_matvec.cu``, ``csrc/qsq_matmul.cu``, ``csrc/qsq_quantize.cu``)
on the current stream and adds one to :data:`launches` under its name.  A
CUDA tensor either runs the kernel or raises; the plain PyTorch version in
``kernels/ref.py`` runs only when the tensors lie on the CPU.  On
``device="meta"`` tensors (the dry run, ``launch/dryrun.py``) a wrapper
makes the same checks as on CUDA and returns ``torch.empty`` outputs of
the kernel's shapes and dtypes on the meta device, launching nothing.

Operands (all kernels): x (M, K) float32 or bfloat16; planes int32,
interleaved (K//32, 3, N) or plane-major (3, K//32, N); scales (K//G, N)
float32; the masked kernels also take ``plane_mask`` (M,) int32, one
3-bit code mask per row from ``ref.MASK_VARIANTS``.  The encoder
(:func:`qsq_quantize`, K5) takes w (K, N) float32 or bfloat16 and returns
Table II codes (K, N) uint8 and scales (K//G, N) float32.
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from repro_torch.core import codec
from repro_torch.kernels import ref

GEMV_M_MAX = 16  # the GEMV kernels hold all of M in one 16-row MMA tile
# a GEMM call of at most this many rows (one 64-row tile) gets the GEMV's
# split of K, so its rows equal the GEMV's bit for bit (speculative verify)
SAME_PLAN_ROWS = 64
SMS = 132  # streaming multiprocessors of an H100 SXM: the plan's fill target
CLUSTER_MAX = 8  # the portable thread-block cluster size
MAX_WARPS = 8  # 256 threads a block
SMEM_MAX = 200 * 1024  # dynamic shared memory the kernels allow themselves

# launches of each kernel, by wrapper name; counted only where a kernel
# is launched (chip_smoke.py resets them and :data:`work` with
# :func:`reset_launches` and reads them around the main path).
# "<name>:fma" also counts the bf16 calls that took the FMA route.
launches: collections.Counter = collections.Counter()
# what the kernels' calls on CUDA and meta tensors do, which no dispatch
# mode sees: "flops" (2 M K N a packed matmul; none for the encoder) and
# "bytes" (each operand read once, each output written once; a packed
# matmul reads only the planes it streams).  On the CPU the plain
# versions' own tensor ops show instead, so nothing is added there.
work: collections.Counter = collections.Counter()

_X_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    """Zero :data:`launches` and :data:`work`."""
    launches.clear()
    work.clear()


class LaunchPlan(NamedTuple):
    """How a packed matmul is cut over the card (``csrc/qsq_mma.cuh``).

    The K words are split into ``cs * wk`` contiguous slices (:meth:`k_slices`),
    summed in slice order; the plan depends only on the kernel kind and
    (M, K, N, G, x dtype), never on ``demand_drop`` or the masks, so masked
    rows stay bit-identical to the unmasked kernel on truncated planes."""
    route: str  # "mma": tensor cores (bf16 x, G % 16 == 0); "fma": the f32 FMA kernel
    mt: int  # 16-row tiles per warp: 1 (GEMV; a long-K GEMM), 4 (GEMM)
    nt: int  # 8-column tiles per warp
    wn: int  # warps along N in a block
    wk: int  # warps along K in a block, each a contiguous K slice
    cs: int  # blocks along K in a thread-block cluster, summed by rank 0
    persist: int = 0  # 1: as many blocks as the card holds, column groups round robin

    @property
    def bn(self) -> int:
        """Columns a block owns."""
        return 8 * self.nt * self.wn

    def grid(self, m: int, n: int) -> tuple[int, int]:
        """The launch grid; a persistent plan's x is at most this, the kernel
        sizes it to the blocks the card holds at once (at least one an SM)."""
        return -(-n // self.bn) * self.cs, -(-m // (16 * self.mt))

    def blocks(self, m: int, n: int) -> int:
        if self.route != "mma":
            return 0
        gx, gy = self.grid(m, n)
        return gx * gy

    def smem_bytes(self, k: int, n_planes: int = 3) -> int:
        """Shared memory of one block at most (``qsq_mma.cuh`` ``smem_bytes``,
        with the masked GEMM's extra tiles): x rows over the block's K range
        and each warp's ring (or the warps' partial sums), then rank 0's slots
        for the other cluster ranks' sums."""
        kw = k // 32
        stages = 8 if self.mt == 1 else 4
        tm = self.mt + n_planes - 1 if self.mt > 1 else self.mt
        tile = 16 * tm * self.bn * 4
        xs = 32 * -(-kw // self.cs) + 16
        loop = 16 * self.mt * xs * 2 + self.wn * self.wk * stages * (n_planes + 2) * self.nt * 32
        main = -(-max(loop, (self.wk - 1) * tile) // 16) * 16
        return main + (self.cs - 1) * tile

    def k_slices(self, k: int) -> list[tuple[int, int]]:
        """The K range [lo, hi) of every slice, in reduction order: warp w
        of cluster rank r holds slice r * wk + w (the kernel's slice_lo)."""
        kw, s = k // 32, self.cs * self.wk
        return [(32 * (i * kw // s), 32 * ((i + 1) * kw // s)) for i in range(s)]


FMA = LaunchPlan("fma", 0, 0, 0, 0, 0)


@functools.lru_cache(maxsize=1024)  # a pure function of its arguments, called per launch
def launch_plan(kind: str, m: int, k: int, n: int, group_size: int,
                x_dtype: torch.dtype) -> LaunchPlan:
    """The split of one call of the GEMV (``kind="gemv"``) or GEMM kernel.

    Wide N (at least two 64-column tiles an SM): a persistent grid, 8 warps
    a block, 16 columns a warp, each over all of K.  Otherwise 8-column
    warps, 4 warps a block along K, and the fewest blocks along K in a
    cluster (at most 4 when a block keeps 4 warps along K) that put
    :data:`SMS` blocks on the card, or as many as there are.

    At one row tile (the GEMV, and the GEMM up to :data:`SAME_PLAN_ROWS`
    rows) a plan must fit both kernels' shared memory, so the two kinds
    take the same split and their rows agree bit for bit.  Two cases fit
    the GEMV's 16 rows of x alone: where the GEMM's 64 resident x rows fit
    at no cluster size (long K: deepseek-7b's and qwen3-14b's ``wd``), and
    a persistent GEMV over very wide N (at least four 64-column tiles an
    SM: the LM heads), which a 64-row tile would cut into many short K
    slices.  There, and wherever its 64-row tile does not fit the split,
    the GEMM runs on the GEMV's 16-row tiles (``mt = 1``, one tile a block
    along the grid's y); at one row tile it still takes the GEMV's split."""
    if x_dtype != torch.bfloat16 or group_size % 16:
        return FMA
    if kind == "gemv" or m <= SAME_PLAN_ROWS:  # one row tile: the GEMV's split
        plan = _split(k, n, 1, (1, 4))
        if plan is None or (not plan.persist and -(-n // 64) >= 4 * SMS):
            gemv = _split(k, n, 1, (1,))  # a split that fits the GEMV's rows alone
            if plan is None or (gemv is not None and gemv.persist):
                plan = gemv
    else:
        plan = _split(k, n, -(-m // 64), (4,)) or _split(k, n, -(-m // 16), (1,))
    if plan is None:
        return FMA
    if kind == "gemv" or plan._replace(mt=4).smem_bytes(k) > SMEM_MAX:
        return plan._replace(mt=1)
    return plan._replace(mt=4)


def _split(k: int, n: int, row_tiles: int, heights: tuple[int, ...]) -> LaunchPlan | None:
    """The split of :func:`launch_plan` over ``row_tiles`` row tiles, whose
    shared memory fits every tile height in ``heights`` (16-row tiles per
    warp: 1 or 4), or None."""
    kw = k // 32

    def fits(plan: LaunchPlan) -> bool:
        return all(plan._replace(mt=t).smem_bytes(k) <= SMEM_MAX for t in heights)

    plan = LaunchPlan("mma", heights[-1], 2, MAX_WARPS, 1, 1, persist=1)
    if -(-n // 64) * row_tiles >= 2 * SMS and fits(plan):
        return plan
    wk = min(4, kw)
    for wn in (2, 1):
        tiles = -(-n // (8 * wn)) * row_tiles
        cs = 1
        while cs < CLUSTER_MAX and tiles * cs < SMS and 2 * cs * wk <= kw:
            cs *= 2
        if tiles * cs >= SMS:
            break
    plan = LaunchPlan("mma", heights[-1], 1, wn, wk, cs)
    while not fits(plan) and 2 * plan.cs <= CLUSTER_MAX:
        # x over a shorter K range: more blocks along K, fewer warps if need be
        wk = plan.wk if 4 * plan.cs * plan.wk <= 2 * kw else max(1, plan.wk // 2)
        if 2 * plan.cs * wk > kw:
            break
        plan = plan._replace(cs=2 * plan.cs, wk=wk)
    return plan if fits(plan) else None


def _shape(x, planes, scales, group_size: int, plane_major: bool,
           demand_drop: int) -> tuple[int, int, int]:
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    n = planes.shape[-1]
    if k % 32 or group_size < 1 or k % group_size:
        raise ValueError(f"K={k} must be a multiple of 32 and of group_size={group_size}")
    want = (3, k // 32, n) if plane_major else (k // 32, 3, n)
    if tuple(planes.shape) != want:
        raise ValueError(f"planes shape {tuple(planes.shape)} != {want}")
    if tuple(scales.shape) != (k // group_size, n):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(k // group_size, n)}")
    if not 0 <= demand_drop <= 2:
        raise ValueError(f"demand_drop must be 0..2, got {demand_drop}")
    return m, k, n


def _on_cpu(*ts) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"the QSQ kernels run on CUDA, CPU or meta tensors, not {dev}")
    return False


def _check_cuda(x, planes, scales, plane_mask=None) -> None:
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if planes.dtype != torch.int32 or scales.dtype != torch.float32:
        raise TypeError(f"planes int32 and scales float32 expected, got "
                        f"{planes.dtype} and {scales.dtype}")
    ops = [x, planes, scales]
    if plane_mask is not None:
        if plane_mask.dtype != torch.int32 or tuple(plane_mask.shape) != (x.shape[0],):
            raise TypeError(f"plane_mask must be int32 of shape ({x.shape[0]},)")
        ops.append(plane_mask)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the QSQ kernels take contiguous operands")


def _launch(name: str, x, planes, scales, plane_mask, group_size: int,
            sign_mag: bool, plane_major: bool, tail: int) -> torch.Tensor:
    m, k = x.shape
    n = planes.shape[-1]
    # planes streamed: ``tail`` is the unmasked kernels' count and the masked
    # ones' demand drop; the interleaved layout reads all three
    n_read = (3 - tail if plane_mask is not None else tail) if plane_major else 3
    work["flops"] += 2 * m * k * n
    work["bytes"] += (x.numel() * x.element_size() + n_read * (k // 32) * n * 4
                      + scales.numel() * 4 + m * n * 4 + (4 * m if plane_mask is not None else 0))
    if x.device.type == "meta":  # the dry run: shapes only
        return torch.empty((m, n), dtype=torch.float32, device="meta")
    from repro_torch.kernels import build  # deferred: builds on first launch

    p = launch_plan("gemv" if name.startswith("qsq_matvec") else "gemm", m, k, n,
                    group_size, x.dtype)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    # a GEMM plan on 16-row tiles launches the GEMV's instantiation of the
    # template (its C entry takes any M on the tensor-core route)
    entry = name.replace("qsq_matmul", "qsq_matvec") if p.mt == 1 else name
    fn = getattr(build.load(), entry)
    ptrs = [x.data_ptr()] + ([plane_mask.data_ptr()] if plane_mask is not None else [])
    ptrs += [planes.data_ptr(), scales.data_ptr(), out.data_ptr()]
    rc = fn(*ptrs, m, k, n, group_size, int(x.dtype == torch.bfloat16),
            int(sign_mag), int(plane_major), tail, p.nt, p.wn, p.wk, p.cs, p.persist,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (M={m}, K={k}, N={n}, "
                           f"G={group_size}): CUDA error {rc}")
    launches[name] += 1
    if p.route == "fma" and x.dtype == torch.bfloat16:
        launches[f"{name}:fma"] += 1  # a bf16 call off the tensor-core route
    return out


def qsq_matvec(x, planes, scales, *, group_size: int, sign_mag: bool = False,
               plane_major: bool = False, demand_drop: int = 0) -> torch.Tensor:
    """K1: small-M x @ decode(planes, scales) -> (M, N) f32; on plane-major
    planes only the leading ``3 - demand_drop`` planes are read."""
    m, _, _ = _shape(x, planes, scales, group_size, plane_major, demand_drop)
    if demand_drop and not plane_major:
        raise ValueError("demand_drop requires the plane-major layout")
    if _on_cpu(x, planes, scales):
        return ref.qsq_matmul_ref(x, planes, scales, group_size, sign_mag=sign_mag,
                                  plane_major=plane_major, n_planes=3 - demand_drop)
    if m > GEMV_M_MAX or group_size % 16:
        raise ValueError(f"qsq_matvec takes M <= {GEMV_M_MAX} and G a multiple of 16; "
                         f"got M={m}, G={group_size}")
    _check_cuda(x, planes, scales)
    return _launch("qsq_matvec", x, planes, scales, None, group_size, sign_mag,
                   plane_major, 3 - demand_drop)


def qsq_matvec_masked(x, plane_mask, planes, scales, *, group_size: int,
                      sign_mag: bool = False, plane_major: bool = False,
                      demand_drop: int = 0) -> torch.Tensor:
    """K2: K1 with one plane mask per row; rows whose mask is not in
    ``MASK_VARIANTS[demand_drop:]`` come out zero."""
    m, _, _ = _shape(x, planes, scales, group_size, plane_major, demand_drop)
    if _on_cpu(x, planes, scales, plane_mask):
        return ref.qsq_matmul_plane_mask_ref(
            x, plane_mask, planes, scales, group_size, sign_mag=sign_mag,
            plane_major=plane_major, demand_drop=demand_drop)
    if m > GEMV_M_MAX or group_size % 16:
        raise ValueError(f"qsq_matvec_masked takes M <= {GEMV_M_MAX} and G a multiple "
                         f"of 16; got M={m}, G={group_size}")
    _check_cuda(x, planes, scales, plane_mask)
    return _launch("qsq_matvec_masked", x, planes, scales, plane_mask, group_size,
                   sign_mag, plane_major, demand_drop)


def qsq_matmul(x, planes, scales, *, group_size: int, sign_mag: bool = False,
               plane_major: bool = False, demand_drop: int = 0) -> torch.Tensor:
    """K3: tiled GEMM x @ decode(planes, scales) -> (M, N) f32."""
    _shape(x, planes, scales, group_size, plane_major, demand_drop)
    if demand_drop and not plane_major:
        raise ValueError("demand_drop requires the plane-major layout")
    if _on_cpu(x, planes, scales):
        return ref.qsq_matmul_ref(x, planes, scales, group_size, sign_mag=sign_mag,
                                  plane_major=plane_major, n_planes=3 - demand_drop)
    _check_cuda(x, planes, scales)
    return _launch("qsq_matmul", x, planes, scales, None, group_size, sign_mag,
                   plane_major, 3 - demand_drop)


def qsq_matmul_masked(x, plane_mask, planes, scales, *, group_size: int,
                      sign_mag: bool = False, plane_major: bool = False,
                      demand_drop: int = 0) -> torch.Tensor:
    """K4: K3 with one plane mask per row (the K2 contract)."""
    _shape(x, planes, scales, group_size, plane_major, demand_drop)
    if _on_cpu(x, planes, scales, plane_mask):
        return ref.qsq_matmul_plane_mask_ref(
            x, plane_mask, planes, scales, group_size, sign_mag=sign_mag,
            plane_major=plane_major, demand_drop=demand_drop)
    _check_cuda(x, planes, scales, plane_mask)
    return _launch("qsq_matmul_masked", x, planes, scales, plane_mask, group_size,
                   sign_mag, plane_major, demand_drop)


def qsq_quantize(w: torch.Tensor, *, group_size: int, phi: int = 4
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: encode w (K, N), grouped along K, -> (Table II codes (K, N)
    uint8, scales (K//G, N) f32): Eq. 9 alpha per group, then the nearest
    level in {0, +-1, +-2, +-4} capped by phi."""
    if w.dim() != 2 or 0 in w.shape:
        raise ValueError(f"w must be a non-empty (K, N) matrix, got {tuple(w.shape)}")
    k, n = w.shape
    if group_size < 1 or k % group_size:
        raise ValueError(f"group_size={group_size} does not divide K={k}")
    if phi not in (1, 2, 4):
        raise ValueError(f"phi must be one of 1, 2, 4; got {phi}")
    if _on_cpu(w):
        return ref.qsq_quantize_ref(w, group_size, phi)
    if w.dtype not in _X_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("qsq_quantize takes a contiguous w")
    codes = torch.empty((k, n), dtype=torch.uint8, device=w.device)
    scales = torch.empty((k // group_size, n), dtype=torch.float32, device=w.device)
    work["bytes"] += w.numel() * w.element_size() + codes.numel() + scales.numel() * 4
    if w.device.type == "meta":  # the dry run: shapes only
        return codes, scales
    from repro_torch.kernels import build  # deferred: builds on first launch

    rc = build.load().qsq_quantize(w.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                                   k, n, group_size, phi, int(w.dtype == torch.bfloat16),
                                   torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qsq_quantize launch failed (K={k}, N={n}, G={group_size}, "
                           f"phi={phi}): CUDA error {rc}")
    launches["qsq_quantize"] += 1
    return codes, scales


def pack_weight(w: torch.Tensor, *, group_size: int, phi: int = 4
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense weight (K, N) -> (interleaved Table II bit-planes (K//32, 3, N)
    int32, scales (K//G, N) f32), the operands :func:`qsq_matmul` takes."""
    codes, scales = qsq_quantize(w, group_size=group_size, phi=phi)
    return codec.pack_bitplane(codes), scales
