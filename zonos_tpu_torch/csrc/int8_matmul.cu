// K1: int8 weight-only GEMV for the decode projections and the int8 heads.
//
// Replaces the TPU kernel zonos_tpu/ops/pallas_matmul.py::int8_matmul
// (body _kernel): y[b, n] = (sum_k x[b, k] * wq[k, n]) * s[n], x bf16 [B, K]
// with 1 <= B <= 16, wq int8 [K, N] with row stride ldw (unit column
// stride), s f32 [N], y f32 [B, N]. Products are exact in f32, sums f32.
//
// Bound on an H100: device-memory bytes (the int8 weight, read once: 6.3 MB
// for in_proj, 18.9 MB for the heads, against KBs of x). A decode GEMV has
// few column tiles, so the K axis is split too. Design: ONE launch, grid
// (K ranks, column tiles of 256), the K ranks of a tile forming one
// thread-block cluster, their number chosen so the blocks fill whole waves
// of the SMs (ops/cuda_matmul.int8_matmul_plan):
//   * one thread streams the block's weight slab into a ring of up to 3
//     slots in shared memory, one 2-D TMA copy (a [128, 256] box of a tensor
//     map of the weight) per slot, each completing on the slot's mbarrier;
//     at the main-path shapes the whole slab fits the ring, so every byte
//     is in flight at once while the other warps stage x's slab (f32,
//     k-major) in shared memory;
//   * a thread takes 4 columns (one 32-bit word of a row) and every 8th
//     row of a slot (16 rows, unrolled), dequantizes by byte permutes
//     (exact) and sums all B rows in f32, starting as soon as a slot lands;
//   * the block adds its 8 row groups, and each rank pushes its sums for
//     the columns that rank r owns into rank r's shared memory (distributed
//     shared memory stores); after one cluster barrier rank r adds the
//     ranks' sums in rank order, applies the scale once and writes y:
//     deterministic, no atomics, no partial buffer in device memory.
// A row stride or base that is not 16-byte aligned (which a tensor map
// cannot describe) takes the scalar variant of the same kernel: the threads
// fill each slot with byte loads.
//
// At in_proj, B 2, the time goes to three things of similar size: the wait
// for the first TMA box after the block starts, the dequantize-and-FMA loop,
// and the cluster reduction (mostly waiting for the slowest rank). 16-byte
// cp.async copies and fp16 tensor-core products were tried in this
// structure and were slower.

#include "gemv_cluster.cuh"

// The body is int8_gemv_cluster in gemv_cluster.cuh (K3's fc2 runs it too).
// cluster K ranks of kc rows each (cluster * kc >= K), smem_bytes as
// ops/cuda_matmul.int8_matmul_plan lays it out, the ring at most 3 slots.
extern "C" int zt_int8_matmul(const void* x, const void* wq, long long ldw, const void* scale, void* y,
                              int B, int K, int N, int cluster, int kc, int smem_bytes, void* stream)
{
    return zt::launch_gemv<false>(x, wq, ldw, scale, y, B, K, N, cluster, kc, 3, smem_bytes,
                                  reinterpret_cast<cudaStream_t>(stream));
}
