"""Streaming probes K5 and K6 (port of the Pallas kernels of ``tools/bench_stream.py``).

Both sum an int8 array [R, C] into one int32 and exist to measure how fast the
card streams device memory, the rate every bound in PERF.md assumes:

* K5 ``grid_sum_once`` (``csrc/stream_sum.cu``) replaces the Pallas
  ``grid_sum_once``: one block per [blk, C] tile, 16-byte loads into registers.
* K6 ``manual_sum_once`` (``csrc/stream_sum.cu``) replaces the Pallas
  ``manual_sum_once``: a persistent grid, each block streaming its stages
  through a two-slot ``cp.async`` ring in shared memory.

int32 wraparound addition is associative, so the kernels, the plain version
and ``torch.sum(w, dtype=torch.int32)`` agree exactly. Each wrapper takes the
plain version for a tensor on the CPU, and only there; for a CUDA tensor it
launches its kernel or raises. ``launches`` on each wrapper counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from zonos_tpu_torch.ops import _build
from zonos_tpu_torch.ops.cuda_matmul import _ptr, _stream

STAGE_BYTES_MAX = 64 * 1024  # one K6 ring slot; two of them fit the SM's shared memory


def stream_sum_plain(w: torch.Tensor, blk: int) -> torch.Tensor:
    """Σ w as int32 (wrapping): per block of ``blk`` rows in int64, then the
    partials added and wrapped to 32 bits. Returns a 0-d int32 tensor."""
    _check_shape(w, blk, "stream_sum_plain")
    total = w.reshape(w.shape[0] // blk, -1).sum(dim=1, dtype=torch.int64).sum()
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)  # stays on the device


def _check_shape(w: torch.Tensor, blk: int, name: str) -> None:
    if w.dtype != torch.int8 or w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"{name}: w must be a contiguous int8 [R, C] tensor, got {w.dtype} {tuple(w.shape)}")
    if blk <= 0 or w.shape[0] % blk != 0:
        raise ValueError(f"{name}: R {w.shape[0]} must be a multiple of blk {blk}")


def _check_cuda(w: torch.Tensor, blk: int, name: str) -> None:
    _check_shape(w, blk, name)
    if w.shape[1] % 16 != 0 or w.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: C {w.shape[1]} must be a multiple of 16 and w 16-byte aligned")


def grid_sum_once(w: torch.Tensor, blk: int) -> torch.Tensor:
    """K5: Σ w (int8 [R, C]) as a 0-d int32 tensor, one block per [blk, C] tile."""
    if w.device.type == "cpu":
        return stream_sum_plain(w, blk)
    _check_cuda(w, blk, "grid_sum_once")
    out = torch.zeros((), dtype=torch.int32, device=w.device)
    err = _lib().zt_grid_sum(_ptr(w), w.numel(), blk * w.shape[1], _ptr(out), _stream())
    _build.check(err, "grid_sum_once")
    _build.count_launch(grid_sum_once)
    return out


grid_sum_once.launches = 0


def manual_stage_bytes(blk: int, c: int) -> int:
    """K6's ring slot: one [blk, C] chunk, cut to at most STAGE_BYTES_MAX."""
    return min(blk * c, STAGE_BYTES_MAX)


def manual_sum_once(w: torch.Tensor, blk: int) -> torch.Tensor:
    """K6: Σ w (int8 [R, C]) as a 0-d int32 tensor, through a two-stage ring
    on a persistent grid of one block per SM."""
    if w.device.type == "cpu":
        return stream_sum_plain(w, blk)
    _check_cuda(w, blk, "manual_sum_once")
    stage = manual_stage_bytes(blk, w.shape[1])
    n_stages = -(-w.numel() // stage)
    blocks = min(torch.cuda.get_device_properties(w.device).multi_processor_count, n_stages)
    out = torch.zeros((), dtype=torch.int32, device=w.device)
    err = _lib().zt_manual_sum(_ptr(w), w.numel(), stage, blocks, _ptr(out), _stream())
    _build.check(err, "manual_sum_once")
    _build.count_launch(manual_sum_once)
    return out


manual_sum_once.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("stream_sum")
    lib.zt_grid_sum.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.zt_grid_sum.restype = ctypes.c_int
    lib.zt_manual_sum.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.zt_manual_sum.restype = ctypes.c_int
    return lib
