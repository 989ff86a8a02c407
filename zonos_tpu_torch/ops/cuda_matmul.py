"""Decode matmul kernels K1, K3 and K4 (port of ``zonos_tpu/ops/pallas_matmul.py``).

* K1 ``int8_matmul`` (``csrc/int8_matmul.cu``) replaces the Pallas
  ``int8_matmul``: y = x @ wq * s for 1-16 rows, one launch per call (split-K
  reduced inside a thread-block cluster; ``int8_matmul_plan``).
* K3 ``fused_mlp_int8`` / ``fused_mlp_int8_split`` (``csrc/fused_mlp_int8.cu``)
  replace the Pallas ``fused_mlp_int8`` / ``fused_mlp_int8_split``: the
  gated-SiLU MLP with int8 weights, two launches per call (fc1 and the gate
  by F slices into a per-device h scratch, then fc2 on K1's body as a
  programmatic dependent; ``fused_mlp_plan``).
* K4 ``int4_matmul`` (``csrc/int4_matmul.cu``) replaces the Pallas
  ``int4_matmul``: y = x @ dequant(q4, s4) for 1-16 rows, group-wise int4, one
  launch per call (whole groups per cluster rank; ``int4_matmul_plan``).

Each kernel reads its weights by 2-D TMA boxes into a ring in shared memory
and keeps every partial sum on chip: nothing is allocated per call but the
output. Each launch geometry is mirrored here in a frozen plan, which the
CPU tests hold to covering every row, group and column once within the
card's limits.

Each wrapper takes its plain PyTorch version for tensors on the CPU, and only
there; for CUDA tensors it launches the kernel or raises. ``launches`` on each
wrapper counts wrapper calls that launched. The plain versions compute in the
activation dtype's values with f32 sums: at float32 they equal the JAX
package's XLA path, and at bf16 they repeat the kernels' arithmetic (exact
int8 x bf16 products, f32 sums, h rounded to bf16 before fc2).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from zonos_tpu_torch.ops import _build

MAX_ROWS = 16  # K1/K3/K4 take decode-sized row counts; larger batches use torch.matmul


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_x(x: torch.Tensor, k: int, name: str) -> None:
    _require(x.is_cuda and x.dtype == torch.bfloat16, f"{name}: x must be a CUDA bf16 tensor, got {x.dtype} on {x.device}")
    _require(x.dim() == 2 and x.shape[1] == k and x.is_contiguous(), f"{name}: x must be contiguous [B, {k}], got {tuple(x.shape)}")
    _require(1 <= x.shape[0] <= MAX_ROWS, f"{name}: 1 <= B <= {MAX_ROWS} rows, got {x.shape[0]}")


def _check_w(w: torch.Tensor, shape: tuple[int, int], name: str, padded_rows: bool = False) -> None:
    _require(w.is_cuda and w.dtype == torch.int8, f"{name}: weight must be a CUDA int8 tensor")
    _require(tuple(w.shape) == shape, f"{name}: weight shape {tuple(w.shape)} != {shape}")
    if padded_rows:  # K1 takes the row stride: rows may be padded
        _require(w.stride(1) == 1 and w.stride(0) >= shape[1], f"{name}: weight must be row-major, row stride >= N")
    else:
        _require(w.is_contiguous(), f"{name}: weight must be contiguous row-major")


def _check_s(s: torch.Tensor, n: int, name: str) -> torch.Tensor:
    _require(s.is_cuda and s.dtype == torch.float32 and s.numel() == n and s.is_contiguous(),
             f"{name}: scale must be a contiguous CUDA f32 tensor of {n} elements")
    return s


# ---------------------------------------------------------------------------
# K1: int8 GEMV
# ---------------------------------------------------------------------------

K1_COLS = 256  # TN in csrc/int8_matmul.cu: columns per block
K1_ROW_GROUPS = 8  # KG: rows a block's threads take at once
K1_SLOT_ROWS = 128  # SK: rows per ring slot, one TMA box
K1_RING_SLOTS = 3  # NS: ring slots at most
K1_BAR_BYTES = 128  # BAR_BYTES in csrc/gemv_cluster.cuh: the slots' mbarriers
K1_MIN_RANK_ROWS = 64  # fewest K rows worth a cluster rank
K1_MAX_RANK_ROWS = 1024  # x's slab per rank stays <= 64 KB at B 16
K1_FILL = 1.0  # a grid of at least the SMs' count is wide enough
H100_SMS = 132
MAX_CLUSTER = 16  # MAX_CLUSTER: the non-portable cluster limit
MAX_SMEM_BYTES = 232_448  # 227 KB, what one block may use on an H100


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    rows_padded: int  # RB: x's rows padded to 1, 2, 4, 8 or 16
    cluster: int  # K ranks per column tile, one cluster
    kc: int  # K rows per rank
    per: int  # columns of a tile each rank reduces
    slots: int  # ring slots
    smem_bytes: int  # dynamic shared memory per block


def _rows_padded(b: int) -> int:
    return next(r for r in (1, 2, 4, 8, 16) if r >= b)


@functools.cache
def int8_matmul_plan(b: int, k: int, n: int, sms: int = H100_SMS, ring_slots: int = K1_RING_SLOTS,
                     max_cluster: int = MAX_CLUSTER) -> Int8Plan:
    """K1's launch geometry: grid (cluster, ceil(n / 256)), one cluster per column tile.

    The cluster size, at most ``max_cluster``, is the least power of two
    that gives the grid K1_FILL of the SMs, while a rank keeps at least
    K1_MIN_RANK_ROWS rows, and more while a rank would hold more than
    K1_MAX_RANK_ROWS. Shared memory, in the kernel's order: the slots'
    mbarriers, the ring (up to ``ring_slots`` slots of 128 rows of 256 bytes:
    3 for K1, 2 or 4 for K3's fc2, reused afterwards for the 8 row groups'
    sums [8, RB, 256] f32), x's slab [kc, RB] f32, and the sums the other
    ranks push for this rank's columns [cluster, RB, per] f32.
    """
    rb = _rows_padded(b)
    tiles = math.ceil(n / K1_COLS)
    cluster = 1
    while cluster < max_cluster and (
        (tiles * cluster < K1_FILL * sms and math.ceil(k / (2 * cluster)) >= K1_MIN_RANK_ROWS)
        or math.ceil(k / cluster) > K1_MAX_RANK_ROWS
    ):
        cluster *= 2
    kc = math.ceil(k / cluster)
    slots = min(ring_slots, math.ceil(kc / K1_SLOT_ROWS))
    per = math.ceil(K1_COLS / cluster)
    ring = max(slots * K1_SLOT_ROWS * K1_COLS, K1_ROW_GROUPS * rb * K1_COLS * 4)
    return Int8Plan(rb, cluster, kc, per, slots, K1_BAR_BYTES + ring + kc * rb * 4 + cluster * rb * per * 4)


def int8_rank_stages(k: int, plan: Int8Plan) -> list[list[tuple[int, int]]]:
    """Per rank, (first K row, row count) of each ring stage: the kernel's walk over K."""
    out = []
    for r in range(plan.cluster):
        begin = min(k, r * plan.kc)
        rows = min(k, begin + plan.kc) - begin
        out.append([(begin + j, min(K1_SLOT_ROWS, rows - j)) for j in range(0, rows, K1_SLOT_ROWS)])
    return out


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def int8_vector_path(w: torch.Tensor) -> bool:
    """Whether K1 fills its ring by TMA copies (else by byte loads)."""
    return w.stride(0) % 16 == 0 and w.data_ptr() % 16 == 0


def _mm_f32(x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    # int8 and bf16 values are exact in f32: exact products, f32 sums.
    return torch.matmul(x.float(), wq.float())


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y[b, n] = (sum_k x[b,k] * wq[k,n]) * scale[n] → [B, N] f32."""
    return _mm_f32(x, wq) * scale.reshape(1, -1).float()


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [B, K] · wq [K, N] int8 · scale [N] or [1, N] f32 → [B, N] f32.

    wq may be a view with rows padded (row stride >= N, unit column stride),
    as the port stores the int8 heads: see ``quant.pad_rows16``.
    """
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale)
    b, k = x.shape
    n = wq.shape[1]
    _check_x(x, k, "int8_matmul")
    _check_w(wq, (k, n), "int8_matmul", padded_rows=True)
    _check_s(scale, n, "int8_matmul")
    plan = int8_matmul_plan(b, k, n, sms=_sm_count(x.device))
    _require(plan.smem_bytes <= MAX_SMEM_BYTES,
             f"int8_matmul: K {k} at B {b} needs {plan.smem_bytes} bytes of shared memory")
    y = torch.empty((b, n), dtype=torch.float32, device=x.device)
    err = _lib().zt_int8_matmul(_ptr(x), _ptr(wq), wq.stride(0), _ptr(scale), _ptr(y), b, k, n,
                                plan.cluster, plan.kc, plan.smem_bytes, _stream())
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0


# ---------------------------------------------------------------------------
# K3: gated-SiLU MLP
# ---------------------------------------------------------------------------

def _mlp_plain(x, w1y, s1y, w1g, s1g, w2q, s2):
    y = _mm_f32(x, w1y) * s1y.reshape(1, -1).float()
    g = _mm_f32(x, w1g) * s1g.reshape(1, -1).float()
    h = (y * (g * torch.sigmoid(g))).to(x.dtype)  # bf16 before fc2 when x is bf16
    return _mm_f32(h, w2q) * s2.reshape(1, -1).float()


def fused_mlp_int8_plain(x, w1q, s1, w2q, s2):
    f = w1q.shape[1] // 2
    s1 = s1.reshape(-1)
    return _mlp_plain(x, w1q[:, :f], s1[:f], w1q[:, f:], s1[f:], w2q, s2)


def fused_mlp_int8_split_plain(x, w1yq, s1y, w1gq, s1g, w2q, s2):
    return _mlp_plain(x, w1yq, s1y, w1gq, s1g, w2q, s2)


K3_COLS = 128  # FC in csrc/fused_mlp_int8.cu: F columns per fc1 cluster, in each half
K3_RANKS = 2  # RANKS: an fc1 cluster's ranks split D; each finishes K3_COLS / 2 columns
K3_ROW_GROUPS = 8  # KG
K3_SLOT_ROWS = 64  # S1: D rows per ring slot, one [64, 128] box per half
K3_RING_SLOTS = 8  # fc1 ring slots at B > 4
K3_SHARED_ROWS = 4  # at B <= 4 fc1 and fc2 are sized to share an SM:
K3_SHARED_RING_SLOTS = 4  # fc1's ring then,
K3_SHARED_FC2_SLOTS = 2  # and fc2's (K1's body, cluster 16)
K3_FC2_RING_SLOTS = 4  # fc2 at B > 4, in clusters of at most
K3_FC2_MAX_CLUSTER = 8  # 8 ranks (1024 rows of w2 each)
SM_SMEM_BYTES = 233_472  # 228 KB of shared memory per H100 SM
SMEM_RESERVED_BYTES = 1024  # the runtime's share of each block


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    rows_padded: int  # RB: x's rows padded to 1, 2, 4, 8 or 16
    blocks: int  # fc1 blocks: K3_RANKS per K3_COLS columns of y and of the gate
    fc1_slots: int  # fc1 ring slots
    fc1_smem_bytes: int  # fc1's dynamic shared memory per block
    fc2: Int8Plan  # fc2 over h: K1's geometry with K = F


@functools.cache
def fused_mlp_plan(b: int, d: int, f: int, d_out: int, sms: int = H100_SMS) -> MlpPlan:
    """K3's two launches: fc1 + gate on grid (2, ceil(f / 128)) in clusters
    of 2 (each rank half of the d rows), then fc2 on K1's body.

    At B <= 4 the two are sized to share an SM (fc1 4 ring slots, fc2 2 in
    clusters of 16), so that fc2's weight copies overlap fc1; above, fc1
    takes 8 slots and fc2 4 in clusters of at most 8. fc1's shared memory,
    in the kernel's order: the slots' mbarriers, the ring (slots of a
    [64, 128] box of y and one of the gate, reused afterwards for the row
    groups' sums [8, RB, 256] f32), the rank's x rows [ceil(d / 2), RB] bf16
    (padded to 16 bytes) and the sums both ranks push for this rank's
    columns [2, RB, 128] f32.
    """
    rb = _rows_padded(b)
    dh = math.ceil(d / K3_RANKS)
    shared = rb <= K3_SHARED_ROWS
    slots = max(1, min(K3_SHARED_RING_SLOTS if shared else K3_RING_SLOTS, math.ceil(dh / K3_SLOT_ROWS)))
    ring = max(slots * 2 * K3_SLOT_ROWS * K3_COLS, K3_ROW_GROUPS * rb * 2 * K3_COLS * 4)
    smem = K1_BAR_BYTES + ring + -(-dh * rb * 2 // 16) * 16 + K3_RANKS * rb * K3_COLS * 4
    fc2 = (int8_matmul_plan(b, f, d_out, sms, ring_slots=K3_SHARED_FC2_SLOTS) if shared
           else int8_matmul_plan(b, f, d_out, sms, ring_slots=K3_FC2_RING_SLOTS, max_cluster=K3_FC2_MAX_CLUSTER))
    return MlpPlan(rb, K3_RANKS * math.ceil(f / K3_COLS), slots, smem, fc2)


def fused_mlp_columns(f: int, plan: MlpPlan) -> list[tuple[int, int]]:
    """Per fc1 block (cluster by cluster, rank by rank), (first F column,
    column count) that it finishes: the ranks' sums added, the gate applied
    and h written, for y's columns and the same of the gate."""
    own = K3_COLS // K3_RANKS
    return [(c, max(0, min(own, f - c))) for c in range(0, plan.blocks * own, own)]


def fused_mlp_stages(d: int) -> list[list[tuple[int, int]]]:
    """Per fc1 rank, (first D row, row count) of each ring stage; every
    cluster walks the same rows."""
    dh = math.ceil(d / K3_RANKS)
    out = []
    for r in range(K3_RANKS):
        lo, hi = min(d, r * dh), min(d, (r + 1) * dh)
        out.append([(k, min(K3_SLOT_ROWS, hi - k)) for k in range(lo, hi, K3_SLOT_ROWS)])
    return out


_H_SCRATCH: dict[int, torch.Tensor] = {}


def _h_scratch(device: torch.device, numel: int) -> torch.Tensor:
    """K3's h [B, F] bf16, one buffer per device kept across calls (grown when
    a call needs more): written by fc1 and read by fc2 of the same call, which
    run in order on the caller's stream."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    buf = _H_SCRATCH.get(idx)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.bfloat16, device=device)
        _H_SCRATCH[idx] = buf
    return buf


def reserve_mlp_scratch(device, f: int) -> torch.Tensor:
    """Size K3's h scratch on ``device`` for MLPs up to width ``f`` at any B
    K3 takes, so that no later call grows (and moves) it: a model whose MLPs
    have two widths (the hybrid: 4096 and 8192) calls this once, with the
    larger."""
    return _h_scratch(torch.device(device), MAX_ROWS * f)


def _launch_mlp(x, w1y, w1g, ld1, s1y, s1g, w2q, s2, f):
    b, d = x.shape
    d_out = w2q.shape[1]
    _check_w(w2q, (f, d_out), "fused_mlp_int8")
    _check_s(s2, d_out, "fused_mlp_int8")
    _require(ld1 % 16 == 0 and d_out % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (w1y, w1g, w2q)),
             "fused_mlp_int8: the weights are read by TMA: rows and bases must be 16-byte aligned")
    plan = fused_mlp_plan(b, d, f, d_out, sms=_sm_count(x.device))
    _require(max(plan.fc1_smem_bytes, plan.fc2.smem_bytes) <= MAX_SMEM_BYTES,
             f"fused_mlp_int8: D {d}, F {f} at B {b} needs more than {MAX_SMEM_BYTES} bytes of shared memory")
    h = _h_scratch(x.device, b * f)
    y = torch.empty((b, d_out), dtype=torch.float32, device=x.device)
    err = _lib_mlp().zt_fused_mlp_int8(
        _ptr(x), _ptr(w1y), _ptr(w1g), ld1, _ptr(s1y), _ptr(s1g), _ptr(w2q), _ptr(s2), _ptr(h), _ptr(y),
        b, d, f, d_out, plan.fc1_slots, plan.fc1_smem_bytes, plan.fc2.cluster, plan.fc2.kc, plan.fc2.slots,
        plan.fc2.smem_bytes, _stream(),
    )
    _build.check(err, "fused_mlp_int8")
    return y


def fused_mlp_int8(x, w1q, s1, w2q, s2):
    """x [B, D] bf16; w1q [D, 2F] int8 (y = cols [0, F), gate = [F, 2F)); s1 [2F];
    w2q [F, Dout] int8; s2 [Dout] → [B, Dout] f32."""
    if x.device.type == "cpu":
        return fused_mlp_int8_plain(x, w1q, s1, w2q, s2)
    b, d = x.shape
    f = w1q.shape[1] // 2
    _check_x(x, d, "fused_mlp_int8")
    _check_w(w1q, (d, 2 * f), "fused_mlp_int8")
    s1 = _check_s(s1, 2 * f, "fused_mlp_int8").reshape(-1)
    y = _launch_mlp(x, w1q, w1q[:, f:], 2 * f, s1, s1[f:], w2q, s2, f)
    fused_mlp_int8.launches += 1
    return y


fused_mlp_int8.launches = 0


def fused_mlp_int8_split(x, w1yq, s1y, w1gq, s1g, w2q, s2):
    """fused_mlp_int8 with the y and gate projections as separate [D, F] arrays."""
    if x.device.type == "cpu":
        return fused_mlp_int8_split_plain(x, w1yq, s1y, w1gq, s1g, w2q, s2)
    b, d = x.shape
    f = w1yq.shape[1]
    _check_x(x, d, "fused_mlp_int8_split")
    _check_w(w1yq, (d, f), "fused_mlp_int8_split")
    _check_w(w1gq, (d, f), "fused_mlp_int8_split")
    _check_s(s1y, f, "fused_mlp_int8_split")
    _check_s(s1g, f, "fused_mlp_int8_split")
    y = _launch_mlp(x, w1yq, w1gq, f, s1y, s1g, w2q, s2, f)
    fused_mlp_int8_split.launches += 1
    return y


fused_mlp_int8_split.launches = 0


# ---------------------------------------------------------------------------
# K4: group-wise int4 GEMV
# ---------------------------------------------------------------------------

def unpack_nibbles(packed: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 [..., group/2, N] → values [..., group, N] in ``dtype``.

    Low nibbles are group rows [0, group/2), high nibbles rows [group/2, group),
    both two's complement.
    """
    p = packed.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=-2).to(dtype)


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """y[b, n] = sum_g s4[g, n] * (x[b, group g] @ q[group g, n]) → [B, N] f32.

    Exact products (bf16 or f32 x int4 in f32), per-group f32 sums, the scale
    applied to each group's sum: what K4 computes, and at float32 the JAX
    package's XLA path.
    """
    g, half, n = q4.shape
    xg = x.float().reshape(x.shape[0], g, 2 * half)
    y = torch.einsum("bgk,gkn->bgn", xg, unpack_nibbles(q4, torch.float32))
    return (y * s4.reshape(1, g, n).float()).sum(dim=1)


K4_COLS = 256  # TN in csrc/int4_matmul.cu: columns per block
K4_RING_SLOTS = 8  # MAX_SLOTS: ring slots at most, one group each
K4_MAX_RANK_ROWS = 1024  # x's slab per rank stays <= 64 KB at B 16


def k4_row_groups(rows_padded: int) -> int:
    """Geom::KG in csrc/int4_matmul.cu: 512 threads in row groups of 64; at
    B 16 two halves of 4 (a thread sums at most 8 rows of x), else 8."""
    return 4 if rows_padded == 16 else 8


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    rows_padded: int  # RB: x's rows padded to 1, 2, 4, 8 or 16
    cluster: int  # K ranks per column tile, one cluster
    gpr: int  # whole groups per rank
    per: int  # columns of a tile each rank reduces
    slots: int  # ring slots, one group each
    smem_bytes: int  # dynamic shared memory per block


@functools.cache
def int4_matmul_plan(b: int, k: int, n: int, group: int, sms: int = H100_SMS) -> Int4Plan:
    """K4's launch geometry: grid (cluster, ceil(n / 256)), one cluster per
    column tile, each rank ``gpr`` whole groups of ``group`` rows.

    The cluster size is the largest power of two that keeps the grid to one
    block per SM (a second wave, or two blocks sharing an SM, was slower at
    fc1 and at B 16) while every rank keeps a group, and larger while a rank
    would hold more than K4_MAX_RANK_ROWS rows. Shared memory, in the
    kernel's order: the slots' mbarriers, the ring (up to 8 slots of a
    group's [group/2, 256] packed bytes, reused afterwards for the row
    groups' sums [row groups, RB, 256] f32), the rank's scales [gpr, 256]
    f32, x's slab [gpr * group, RB] f32, and the sums the other ranks push for
    this rank's columns [cluster, RB, per] f32.
    """
    rb = _rows_padded(b)
    g = k // group
    tiles = math.ceil(n / K4_COLS)
    cluster = 1
    while cluster < MAX_CLUSTER and (
        (tiles * 2 * cluster <= sms and 2 * cluster <= g)
        or math.ceil(g / cluster) * group > K4_MAX_RANK_ROWS
    ):
        cluster *= 2
    gpr = math.ceil(g / cluster)
    slots = min(K4_RING_SLOTS, gpr)
    per = math.ceil(K4_COLS / cluster)
    ring = max(slots * (group // 2) * K4_COLS, k4_row_groups(rb) * rb * K4_COLS * 4)
    smem = K1_BAR_BYTES + ring + gpr * K4_COLS * 4 + gpr * group * rb * 4 + cluster * rb * per * 4
    return Int4Plan(rb, cluster, gpr, per, slots, smem)


def int4_rank_groups(k: int, group: int, plan: Int4Plan) -> list[tuple[int, int]]:
    """Per rank, (first group, group count): the kernel's ring stages, one group each."""
    g = k // group
    out = []
    for r in range(plan.cluster):
        first = min(g, r * plan.gpr)
        out.append((first, min(g, first + plan.gpr) - first))
    return out


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """x [B, K] · dequant(q4 uint8 [G, group/2, N], s4 f32 [G, 1, N]) → [B, N] f32."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, s4)
    _require(q4.dim() == 3 and q4.is_cuda and q4.dtype == torch.uint8 and q4.is_contiguous(),
             f"int4_matmul: q4 must be a contiguous CUDA uint8 [G, group/2, N] tensor, got {tuple(q4.shape)}")
    g, half, n = q4.shape
    b, k = x.shape
    _require(g * 2 * half == k, f"int4_matmul: {g} groups of {2 * half} rows != K {k}")
    _check_x(x, k, "int4_matmul")
    _check_s(s4, g * n, "int4_matmul")
    _require(n % 16 == 0 and half <= 256 and q4.data_ptr() % 16 == 0 and s4.data_ptr() % 16 == 0,
             f"int4_matmul: the packed weight is read by TMA: N ({n}) must be a multiple of 16, "
             f"group/2 ({half}) at most 256, q4 and s4 16-byte aligned")
    plan = int4_matmul_plan(b, k, n, 2 * half, sms=_sm_count(x.device))
    _require(plan.smem_bytes <= MAX_SMEM_BYTES,
             f"int4_matmul: K {k} at B {b} needs {plan.smem_bytes} bytes of shared memory")
    y = torch.empty((b, n), dtype=torch.float32, device=x.device)
    err = _lib_int4().zt_int4_matmul(_ptr(x), _ptr(q4), _ptr(s4), _ptr(y), b, k, n, 2 * half,
                                     plan.cluster, plan.gpr, plan.smem_bytes, _stream())
    _build.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0


# ---------------------------------------------------------------------------
# Library binding (built at first use, never at import)
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_matmul")
    lib.zt_int8_matmul.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.zt_int8_matmul.restype = _I
    return lib


def _lib_mlp() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_int8")
    lib.zt_fused_mlp_int8.argtypes = [_P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.zt_fused_mlp_int8.restype = _I
    return lib


def _lib_int4() -> ctypes.CDLL:
    lib = _build.load("int4_matmul")
    lib.zt_int4_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.zt_int4_matmul.restype = _I
    return lib
