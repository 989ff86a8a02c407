// Int8 weight-streaming GEMV body shared by K1 (int8_matmul.cu) and K3
// (fused_mlp_int8.cu); K4 (int4_matmul.cu) shares its layout and reduce pass.
//
// Computes partial sums of y[b, n] = sum_k x[b, k] * w[k, n] for a few rows b
// (decode: the CFG-doubled batch), with x bf16 and w int8 row-major [K, N].
//
// Bound on an H100: device-memory bytes. The weight is read once and is ~all
// of the traffic (2048 x 3072 int8 = 6.3 MB for in_proj against 8 KB of x),
// so the kernel must keep the 132 SMs streaming:
//   * neighbouring threads read neighbouring 16-byte column groups of a weight
//     row (one 128-bit load per thread, 256 B per half-warp), dequantize in
//     registers and accumulate in f32;
//   * split-K across blocks fills the card: a decode projection has only
//     N / 256 column tiles (12 for in_proj), so grid.y cuts K into chunks and
//     a second pass (gemv_reduce) sums the chunks in a fixed order, applies
//     the per-column scale once and writes f32 — deterministic, no atomics;
//   * 16 threads along K inside the block add their sums through shared memory.
// A simple design: no TMA, no cp.async pipeline, no wgmma (a later PR's work).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zt {

constexpr int GEMV_TX = 16;                   // threads along N, 16 columns each
constexpr int GEMV_TY = 16;                   // threads along K inside a block
constexpr int GEMV_COLS = GEMV_TX * 16;       // 256 columns per block
constexpr int GEMV_THREADS = GEMV_TX * GEMV_TY;
constexpr int GEMV_RED_LD = GEMV_TX * 17;     // padded shared row: no bank conflicts

union Int8x16 {
    int4 v;
    int8_t b[16];
};

// grid: x = column tiles of 256, y = K chunks, z = nmat * ceil(B / R).
// x: [B, K] bf16, row stride ldx. w_a, w_b: int8 weights (row stride ldw);
// z picks w_a or w_b, so one launch covers the two fc1 halves of the MLP.
// partial: [nmat, gridDim.y, B, N] f32.
template <int R, bool VEC>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_int8_partial(const __nv_bfloat16* __restrict__ x, int ldx,
                  const int8_t* __restrict__ w_a, const int8_t* __restrict__ w_b, int ldw,
                  float* __restrict__ partial, int B, int K, int N, int kchunk)
{
    __shared__ float red[GEMV_TY * GEMV_RED_LD];

    const int tx = threadIdx.x % GEMV_TX;
    const int ty = threadIdx.x / GEMV_TX;
    const int row_groups = (B + R - 1) / R;
    const int mat = blockIdx.z / row_groups;
    const int r0 = (blockIdx.z % row_groups) * R;
    const int8_t* __restrict__ w = mat == 0 ? w_a : w_b;
    const int c0 = blockIdx.x * GEMV_COLS + tx * 16;
    const int k_begin = blockIdx.y * kchunk;
    const int k_end = min(K, k_begin + kchunk);

    float acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;

    if (c0 < N) {
#pragma unroll 4
        for (int k = k_begin + ty; k < k_end; k += GEMV_TY) {
            const int8_t* row = w + (size_t)k * ldw + c0;
            Int8x16 wv;
            if (VEC) {
                wv.v = __ldg(reinterpret_cast<const int4*>(row));
            } else {
#pragma unroll
                for (int j = 0; j < 16; ++j) wv.b[j] = (c0 + j < N) ? row[j] : (int8_t)0;
            }
            float xv[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
                xv[r] = (r0 + r < B) ? __bfloat162float(x[(size_t)(r0 + r) * ldx + k]) : 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const float wf = (float)wv.b[j];
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r][j] = fmaf(xv[r], wf, acc[r][j]);
            }
        }
    }

    float* out = partial + ((size_t)mat * gridDim.y + blockIdx.y) * B * N;
    const int c = blockIdx.x * GEMV_COLS + threadIdx.x;  // column this thread reduces
    const int ctx = threadIdx.x / 16, cj = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < 16; ++j) red[ty * GEMV_RED_LD + tx * 17 + j] = acc[r][j];
        __syncthreads();
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < GEMV_TY; ++t) s += red[t * GEMV_RED_LD + ctx * 17 + cj];
        if (c < N && r0 + r < B) out[(size_t)(r0 + r) * N + c] = s;
        __syncthreads();
    }
}

// y[b, n] = scale[n] * sum over chunks of partial[chunk, b, n]  (f32 out).
// A null scale leaves the sum unscaled (K4 scales each group inside its partials).
__global__ void gemv_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
                            float* __restrict__ y, int splits, int B, int N)
{
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= B * N) return;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * B * N + idx];
    y[idx] = scale ? s * scale[idx % N] : s;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int R>
inline void launch_partial_r(dim3 grid, bool vec, cudaStream_t st,
                             const __nv_bfloat16* x, int ldx, const int8_t* wa, const int8_t* wb,
                             int ldw, float* partial, int B, int K, int N, int kchunk)
{
    if (vec)
        gemv_int8_partial<R, true><<<grid, GEMV_THREADS, 0, st>>>(x, ldx, wa, wb, ldw, partial, B, K, N, kchunk);
    else
        gemv_int8_partial<R, false><<<grid, GEMV_THREADS, 0, st>>>(x, ldx, wa, wb, ldw, partial, B, K, N, kchunk);
}

// Launch the partial pass over nmat (1 or 2) weights of N columns each.
inline void launch_partial(const __nv_bfloat16* x, int ldx, const int8_t* wa, const int8_t* wb,
                           int nmat, int ldw, float* partial, int B, int K, int N,
                           int kchunk, int splits, cudaStream_t st)
{
    const int R = B == 1 ? 1 : (B == 2 ? 2 : 4);
    const bool vec = (ldw % 16 == 0) && (N % 16 == 0) && aligned16(wa) && (nmat == 1 || aligned16(wb));
    dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, splits, nmat * ((B + R - 1) / R));
    if (R == 1)
        launch_partial_r<1>(grid, vec, st, x, ldx, wa, wb, ldw, partial, B, K, N, kchunk);
    else if (R == 2)
        launch_partial_r<2>(grid, vec, st, x, ldx, wa, wb, ldw, partial, B, K, N, kchunk);
    else
        launch_partial_r<4>(grid, vec, st, x, ldx, wa, wb, ldw, partial, B, K, N, kchunk);
}

inline void launch_reduce(const float* partial, const float* scale, float* y, int splits, int B, int N,
                          cudaStream_t st)
{
    const int total = B * N;
    gemv_reduce<<<(total + 255) / 256, 256, 0, st>>>(partial, scale, y, splits, B, N);
}

}  // namespace zt
