// K4: group-wise int4 weight-only GEMV for the decode projections.
//
// Replaces the TPU kernel zonos_tpu/ops/pallas_matmul.py::int4_matmul (body
// _int4_kernel): y[b, n] = sum_g s4[g, n] * sum_{k in group g} x[b, k] * w[k, n]
// with x bf16 [B, K], 1 <= B <= 16, y f32 [B, N], and w packed two weights to
// a byte: q4 uint8 [G, group/2, N], where byte (g, j, n) holds row
// g*group + j in its low nibble and row g*group + j + group/2 in its high
// nibble, both two's complement; s4 f32 [G, N] (one scale per group and
// output column).
//
// Bound on an H100: device-memory bytes. The packed weight (K*N/2 bytes) and
// the scales (G*N*4 bytes, 6% of them at group 128) are ~all of the traffic.
// The design is K1's GEMV body (gemv_int8.cuh) with the unpack added:
//   * neighbouring threads read neighbouring 16-byte column groups of a packed
//     row: one 128-bit load carries 32 weights (16 columns x 2 rows), which are
//     sign-extended from their nibbles in registers;
//   * each thread sums x * q over its rows of a group in f32 (bf16 x int4
//     products are exact) and multiplies that sum by the group's scale once;
//   * split-K across blocks in whole groups, so no group straddles two blocks;
//     the second pass (gemv_reduce, no scale) sums the chunks in a fixed order:
//     deterministic, no atomics.
// The TPU kernel rounds the dequantized weight to bf16 before its dot; here the
// scale multiplies the exact per-group sum in f32, the form of the JAX
// package's XLA path (ops/quant.py::q4einsum_lastdim).
// A simple design: no TMA, no cp.async pipeline, no wgmma (a later PR's work).

#include "gemv_int8.cuh"

namespace zt {

union U8x16 {
    int4 v;
    uint8_t b[16];
};

__device__ __forceinline__ float nibble_lo(uint32_t v) { return (float)((int)(v << 28) >> 28); }
__device__ __forceinline__ float nibble_hi(uint32_t v) { return (float)((int)(v << 24) >> 28); }

// grid: x = column tiles of 256, y = K chunks of groups_per_chunk groups,
// z = ceil(B / R) row groups. partial: [gridDim.y, B, N] f32, already scaled.
template <int R, bool VEC>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_int4_partial(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4,
                  const float* __restrict__ s4, float* __restrict__ partial,
                  int B, int K, int N, int group, int groups_per_chunk)
{
    __shared__ float red[GEMV_TY * GEMV_RED_LD];

    const int tx = threadIdx.x % GEMV_TX;
    const int ty = threadIdx.x / GEMV_TX;
    const int r0 = blockIdx.z * R;
    const int c0 = blockIdx.x * GEMV_COLS + tx * 16;
    const int half = group / 2;
    const int g_begin = blockIdx.y * groups_per_chunk;
    const int g_end = min(K / group, g_begin + groups_per_chunk);

    float acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;

    if (c0 < N) {
        for (int g = g_begin; g < g_end; ++g) {
            float gacc[R][16];
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int c = 0; c < 16; ++c) gacc[r][c] = 0.f;

            const uint8_t* wg = q4 + (size_t)g * half * N + c0;
            const int k0 = g * group;
#pragma unroll 2
            for (int j = ty; j < half; j += GEMV_TY) {
                const uint8_t* row = wg + (size_t)j * N;
                U8x16 wv;
                if (VEC) {
                    wv.v = __ldg(reinterpret_cast<const int4*>(row));
                } else {
#pragma unroll
                    for (int c = 0; c < 16; ++c) wv.b[c] = (c0 + c < N) ? row[c] : (uint8_t)0;
                }
                float xl[R], xh[R];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const bool ok = r0 + r < B;
                    const __nv_bfloat16* xr = x + (size_t)(r0 + r) * K + k0 + j;
                    xl[r] = ok ? __bfloat162float(xr[0]) : 0.f;
                    xh[r] = ok ? __bfloat162float(xr[half]) : 0.f;
                }
#pragma unroll
                for (int c = 0; c < 16; ++c) {
                    const uint32_t v = wv.b[c];
                    const float lo = nibble_lo(v), hi = nibble_hi(v);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        gacc[r][c] = fmaf(xl[r], lo, gacc[r][c]);
                        gacc[r][c] = fmaf(xh[r], hi, gacc[r][c]);
                    }
                }
            }
            const float* sg = s4 + (size_t)g * N + c0;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                const float sv = (VEC || c0 + c < N) ? __ldg(sg + c) : 0.f;
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r][c] = fmaf(gacc[r][c], sv, acc[r][c]);
            }
        }
    }

    float* out = partial + (size_t)blockIdx.y * B * N;
    const int col = blockIdx.x * GEMV_COLS + threadIdx.x;  // column this thread reduces
    const int ctx = threadIdx.x / 16, cj = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < 16; ++c) red[ty * GEMV_RED_LD + tx * 17 + c] = acc[r][c];
        __syncthreads();
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < GEMV_TY; ++t) s += red[t * GEMV_RED_LD + ctx * 17 + cj];
        if (col < N && r0 + r < B) out[(size_t)(r0 + r) * N + col] = s;
        __syncthreads();
    }
}

template <int R>
inline void launch_int4_r(dim3 grid, bool vec, cudaStream_t st, const __nv_bfloat16* x, const uint8_t* q4,
                          const float* s4, float* partial, int B, int K, int N, int group, int gpc)
{
    if (vec)
        gemv_int4_partial<R, true><<<grid, GEMV_THREADS, 0, st>>>(x, q4, s4, partial, B, K, N, group, gpc);
    else
        gemv_int4_partial<R, false><<<grid, GEMV_THREADS, 0, st>>>(x, q4, s4, partial, B, K, N, group, gpc);
}

}  // namespace zt

// Two rows per pass at most: each thread keeps a group sum and a total per
// row and column, so R = 2 holds 64 accumulators; B up to 16 takes 8 row
// groups in grid.z, which re-read the packed weight from L2.
extern "C" int zt_int4_matmul(const void* x, const void* q4, const void* s4, void* partial, void* y,
                              int B, int K, int N, int group, int groups_per_chunk, int splits, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int R = B == 1 ? 1 : 2;
    const bool vec = (N % 16 == 0) && zt::aligned16(q4);
    dim3 grid((N + zt::GEMV_COLS - 1) / zt::GEMV_COLS, splits, (B + R - 1) / R);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* qb = static_cast<const uint8_t*>(q4);
    const auto* sb = static_cast<const float*>(s4);
    auto* pb = static_cast<float*>(partial);
    if (R == 1)
        zt::launch_int4_r<1>(grid, vec, st, xb, qb, sb, pb, B, K, N, group, groups_per_chunk);
    else
        zt::launch_int4_r<2>(grid, vec, st, xb, qb, sb, pb, B, K, N, group, groups_per_chunk);
    zt::launch_reduce(pb, nullptr, static_cast<float*>(y), splits, B, N, st);
    return (int)cudaGetLastError();
}
