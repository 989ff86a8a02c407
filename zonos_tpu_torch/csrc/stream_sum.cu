// K5 and K6: the device-memory streaming probes. Each sums an int8 array
// [R, C] into one int32 (two's-complement wraparound, so any order of the
// additions gives the same bits as torch.sum(w, dtype=torch.int32)).
//
// Replaces the TPU kernels of tools/bench_stream.py:
//   K5 grid_sum_once (body _grid_kernel): a 1-D grid of [blk, C] VMEM blocks,
//      each added into one SMEM scalar, the copies double-buffered by Pallas;
//   K6 manual_sum_once (body _manual_kernel): the array left in HBM and read
//      in [blk, C] chunks through an explicit two-slot DMA ring
//      (make_async_copy, two semaphores).
//
// Bound on an H100: device-memory bytes. Every byte is read once and costs
// one quarter of a dp4a; nothing else is stored. The two designs differ only
// in how the bytes reach the adders:
//   * K5 keeps the TPU kernel's grid: one block per [blk, C] tile, each thread
//     issuing 8 independent 16-byte loads per round straight into registers
//     (no shared memory), summing 4 bytes per __dp4a, then a warp and block
//     reduction and one atomicAdd per block. With blk 512 of a [16384, 8192]
//     array that is 32 blocks, so the bytes in flight per SM decide its rate.
//   * K6 keeps the TPU kernel's explicit ring: a persistent grid of one block
//     per SM, each streaming its stages (a [blk, C] chunk cut to at most
//     64 KiB, since shared memory holds 227 KiB and not the 2 x 4 MiB of VMEM)
//     into a two-stage shared-memory ring with 16-byte cp.async copies
//     (commit_group / wait_group 1), summing one stage from shared memory while
//     the next one lands.
// A simple design: no TMA, no clusters (a later PR's work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace zt {

constexpr int K5_THREADS = 1024;
constexpr int K5_UNROLL = 8;
constexpr int K6_THREADS = 512;
constexpr int ONES = 0x01010101;

__device__ __forceinline__ int sum16(int4 v, int acc)
{
    acc = __dp4a(v.x, ONES, acc);
    acc = __dp4a(v.y, ONES, acc);
    acc = __dp4a(v.z, ONES, acc);
    return __dp4a(v.w, ONES, acc);
}

// Block-wide sum of one int per thread, added into *out by thread 0.
__device__ __forceinline__ void block_sum_into(int v, int* out)
{
    __shared__ int warp_sums[32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        const int n_warps = blockDim.x / 32;
        v = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) atomicAdd(out, v);
    }
}

// K5: block i sums bytes [i * tile_bytes, (i + 1) * tile_bytes).
__global__ void __launch_bounds__(K5_THREADS, 1)
grid_sum_kernel(const int8_t* __restrict__ w, long long tile_bytes, int* __restrict__ out)
{
    const int4* p = reinterpret_cast<const int4*>(w + (size_t)blockIdx.x * tile_bytes);
    const long long n16 = tile_bytes / 16;
    const long long stride = blockDim.x;
    int acc = 0;
    long long i = threadIdx.x;
    for (; i + (K5_UNROLL - 1) * stride < n16; i += K5_UNROLL * stride) {
        int4 v[K5_UNROLL];
#pragma unroll
        for (int u = 0; u < K5_UNROLL; ++u) v[u] = __ldcs(p + i + u * stride);
#pragma unroll
        for (int u = 0; u < K5_UNROLL; ++u) acc = sum16(v[u], acc);
    }
    for (; i < n16; i += stride) acc = sum16(__ldcs(p + i), acc);
    block_sum_into(acc, out);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// K6: stage s covers 16-byte words [s * stage16, min((s + 1) * stage16, n16));
// block b takes stages b, b + gridDim.x, ... through a two-slot ring.
__global__ void __launch_bounds__(K6_THREADS, 1)
manual_sum_kernel(const int8_t* __restrict__ w, long long n16, int stage16, int* __restrict__ out)
{
    extern __shared__ int4 ring[];  // [2][stage16]
    const int4* src = reinterpret_cast<const int4*>(w);
    const long long n_stages = (n16 + stage16 - 1) / stage16;

    auto issue = [&](long long s, int slot) {
        const long long base = s * stage16;
        const int len = (int)min((long long)stage16, n16 - base);
        int4* dst = ring + (size_t)slot * stage16;
        for (int j = threadIdx.x; j < len; j += blockDim.x) cp_async16(dst + j, src + base + j);
    };

    int acc = 0;
    long long s = blockIdx.x;
    if (s < n_stages) issue(s, 0);
    cp_async_commit();
    for (int it = 0; s < n_stages; ++it, s += gridDim.x) {
        const long long next = s + gridDim.x;
        if (next < n_stages) issue(next, (it + 1) & 1);
        cp_async_commit();  // an empty group on the last stage keeps wait_group 1 exact
        cp_async_wait_1();  // this thread's copies of stage s have landed
        __syncthreads();    // and every other thread's
        const int4* cur = ring + (size_t)(it & 1) * stage16;
        const int len = (int)min((long long)stage16, n16 - s * stage16);
        for (int j = threadIdx.x; j < len; j += blockDim.x) acc = sum16(cur[j], acc);
        __syncthreads();    // the slot is read out before the next issue overwrites it
    }
    block_sum_into(acc, out);
}

}  // namespace zt

// out: one int32, zeroed by the caller. R * C must be a multiple of 16 bytes,
// w 16-byte aligned, and R a multiple of blk (the wrapper checks all three).
extern "C" int zt_grid_sum(const void* w, long long total_bytes, long long tile_bytes, void* out, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const unsigned grid = (unsigned)(total_bytes / tile_bytes);
    zt::grid_sum_kernel<<<grid, zt::K5_THREADS, 0, st>>>(static_cast<const int8_t*>(w), tile_bytes,
                                                          static_cast<int*>(out));
    return (int)cudaGetLastError();
}

extern "C" int zt_manual_sum(const void* w, long long total_bytes, int stage_bytes, int blocks, void* out,
                             void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int smem = 2 * stage_bytes;
    cudaError_t err = cudaFuncSetAttribute(zt::manual_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    zt::manual_sum_kernel<<<blocks, zt::K6_THREADS, smem, st>>>(static_cast<const int8_t*>(w), total_bytes / 16,
                                                               stage_bytes / 16, static_cast<int*>(out));
    return (int)cudaGetLastError();
}
