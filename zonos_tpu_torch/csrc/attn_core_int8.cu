// K2: single-query GQA decode attention over the int8 head-major KV cache.
//
// Replaces the TPU kernel zonos_tpu/ops/pallas_attention.py::attn_core_int8
// (body _attn_core_kernel). For each batch row b and query head hq (KV head
// h = hq / G):
//     scores_s = (q . k_int8[s]) * (ks[s] / sqrt(Dh))          (f32)
//     valid s:   pad[b] <= s <= write_index, outside [gap_start, gap_start + gap_len[b])
//     p = softmax over valid s (f32);  out = sum_s bf16(p_s * vs[s]) * v_int8[s]
// q bf16 [B, Hq, 128]; kq / vq int8 [B, Hkv, S, 128] (row stride 128, batch
// and head strides given); ks / vs f32 [B, Hkv, S]; out bf16 [B, Hq, 128].
//
// Bound on an H100: device-memory bytes — the int8 K and V rows and their
// scales up to write_index (2.4 MB per layer at B 2, Hkv 4, S 1152). The TPU
// kernel held the whole layer in VMEM in one grid step; that would give 8
// blocks here. This design is split-KV (flash-decoding):
//   * grid (B * Hkv, S / 64): each block takes 64 cache slots of one KV head
//     and all G query heads that share it, so K/V bytes are read once;
//   * a warp per slot: 32 lanes x 4 bytes read one 128-byte K row coalesced,
//     the G dot products reduce by shuffles; chunks wholly past write_index
//     exit before reading anything;
//   * a chunk-local softmax (max m, sum l) and unnormalised output o go to a
//     workspace, and a combine pass merges the chunks (online softmax) and
//     writes bf16. p * vs is rounded to bf16 before the PV sum, as both JAX
//     paths round it to q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int DH = 128;
constexpr int MAXG = 8;
constexpr int CH = 64;        // cache slots per block
constexpr int THREADS = 128;  // == DH: one thread per output dim in the PV sum

__global__ void __launch_bounds__(THREADS)
attn_partial(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
             const float* __restrict__ ks, const int8_t* __restrict__ vq,
             const float* __restrict__ vs, long long kv_sb, long long kv_sh,
             long long sc_sb, long long sc_sh, const int* __restrict__ write_index,
             const int* __restrict__ pad, const int* __restrict__ gap_len, int gap_start,
             float* __restrict__ part_o, float* __restrict__ part_ml,
             int Hkv, int G, int S, float sm_scale)
{
    __shared__ float sc[MAXG][CH];
    __shared__ float m_s[MAXG];

    const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
    const int split = blockIdx.y, splits = gridDim.y;
    const int s0 = split * CH;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lo = max(pad[b], s0);
    const int hi = min(min(*write_index + 1, S), s0 + CH);
    const int gs = gap_start, ge = gap_start + (gap_len ? gap_len[b] : 0);

    float* o_out = part_o + ((size_t)bh * splits + split) * G * DH;
    float* ml_out = part_ml + ((size_t)bh * splits + split) * G * 2;
    if (lo >= hi) {  // no valid slot here (e.g. past write_index): read nothing
        for (int g = 0; g < G; ++g) o_out[g * DH + tid] = 0.f;
        if (tid < G) {
            ml_out[tid * 2] = -CUDART_INF_F;
            ml_out[tid * 2 + 1] = 0.f;
        }
        return;
    }

    // Lane l holds dims 4l..4l+3 of the G query heads of this KV head.
    float qr[MAXG][4];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            qr[g][i] = g < G ? __bfloat162float(q[((size_t)b * Hkv * G + h * G + g) * DH + 4 * lane + i]) : 0.f;
    }

    const int8_t* kbase = kq + b * kv_sb + h * kv_sh;
    const int8_t* vbase = vq + b * kv_sb + h * kv_sh;
    const float* ksb = ks + b * sc_sb + h * sc_sh;
    const float* vsb = vs + b * sc_sb + h * sc_sh;

    for (int j = warp; j < CH; j += THREADS / 32) {
        const int s = s0 + j;
        const bool valid = s >= lo && s < hi && !(s >= gs && s < ge);  // uniform per warp
        if (!valid) {
            if (lane < G) sc[lane][j] = -CUDART_INF_F;
            continue;
        }
        const char4 kv = *reinterpret_cast<const char4*>(kbase + (size_t)s * DH + 4 * lane);
        const float kscale = ksb[s] * sm_scale;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
                float d = qr[g][0] * (float)kv.x + qr[g][1] * (float)kv.y +
                          qr[g][2] * (float)kv.z + qr[g][3] * (float)kv.w;
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
                if (lane == 0) sc[g][j] = d * kscale;
            }
        }
    }
    __syncthreads();

    if (tid < G) {
        float m = -CUDART_INF_F;
        for (int j = 0; j < CH; ++j) m = fmaxf(m, sc[tid][j]);
        m_s[tid] = m;
    }
    __syncthreads();

    for (int idx = tid; idx < G * CH; idx += THREADS) {
        const int g = idx / CH, j = idx % CH;
        const float sv = sc[g][j];
        sc[g][j] = sv == -CUDART_INF_F ? 0.f : expf(sv - m_s[g]);
    }
    __syncthreads();

    float l = 0.f;
    if (tid < G)
        for (int j = 0; j < CH; ++j) l += sc[tid][j];
    __syncthreads();

    // p * vs rounded to bf16 (q's dtype) before the PV sum.
    for (int idx = tid; idx < G * CH; idx += THREADS) {
        const int g = idx / CH, j = idx % CH;
        const float e = sc[g][j];
        sc[g][j] = e == 0.f ? 0.f : __bfloat162float(__float2bfloat16(e * vsb[s0 + j]));
    }
    __syncthreads();

    float acc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
    for (int s = lo; s < hi; ++s) {
        const float vv = (float)vbase[(size_t)s * DH + tid];
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
            if (g < G) acc[g] = fmaf(sc[g][s - s0], vv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
        if (g < G) o_out[g * DH + tid] = acc[g];
    if (tid < G) {
        ml_out[tid * 2] = m_s[tid];
        ml_out[tid * 2 + 1] = l;
    }
}

// Merge the chunks of each (b, query head): out = sum_c e^(m_c - M) o_c / sum_c e^(m_c - M) l_c.
__global__ void __launch_bounds__(DH)
attn_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
             __nv_bfloat16* __restrict__ out, int Hkv, int G, int splits)
{
    const int bq = blockIdx.x, hq_all = Hkv * G;
    const int b = bq / hq_all, hq = bq % hq_all, h = hq / G, g = hq % G;
    const size_t bh = (size_t)b * Hkv + h;
    const int d = threadIdx.x;

    float M = -CUDART_INF_F;
    for (int c = 0; c < splits; ++c) M = fmaxf(M, part_ml[((bh * splits + c) * G + g) * 2]);
    float num = 0.f, den = 0.f;
    if (M != -CUDART_INF_F) {
        for (int c = 0; c < splits; ++c) {
            const float m = part_ml[((bh * splits + c) * G + g) * 2];
            if (m == -CUDART_INF_F) continue;
            const float w = expf(m - M);
            num += w * part_o[((bh * splits + c) * G + g) * DH + d];
            den += w * part_ml[((bh * splits + c) * G + g) * 2 + 1];
        }
    }
    out[(size_t)bq * DH + d] = __float2bfloat16(den > 0.f ? num / den : 0.f);
}

}  // namespace

extern "C" int zt_attn_core_int8(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, long long kv_sb, long long kv_sh,
                                 long long sc_sb, long long sc_sh, const void* write_index,
                                 const void* pad, const void* gap_len, int gap_start,
                                 void* part_o, void* part_ml, void* out,
                                 int B, int Hkv, int G, int S, int splits, float sm_scale,
                                 void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (G > MAXG || splits * CH < S) return (int)cudaErrorInvalidValue;
    dim3 grid(B * Hkv, splits);
    attn_partial<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const float*>(ks), static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
        kv_sb, kv_sh, sc_sb, sc_sh, static_cast<const int*>(write_index),
        static_cast<const int*>(pad), static_cast<const int*>(gap_len), gap_start,
        static_cast<float*>(part_o), static_cast<float*>(part_ml), Hkv, G, S, sm_scale);
    attn_combine<<<B * Hkv * G, DH, 0, st>>>(
        static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
        static_cast<__nv_bfloat16*>(out), Hkv, G, splits);
    return (int)cudaGetLastError();
}

extern "C" int zt_attn_chunk() { return CH; }
