// K2: single-query GQA decode attention over the int8 head-major KV cache.
//
// Replaces the TPU kernel zonos_tpu/ops/pallas_attention.py::attn_core_int8
// (body _attn_core_kernel). For each batch row b and query head hq (KV head
// h = hq / G):
//     scores_s = (q . k_int8[s]) * ks[s] * (1/sqrt(Dh))        (f32)
//     valid s:   pad[b] <= s <= write_index, outside [gap_start, gap_start + gap_len[b])
//     p = softmax over valid s (f32);  out = sum_s bf16(p_s * vs[s]) * v_int8[s]
// q bf16 [B, Hq, 128]; kq / vq int8 [B, Hkv, S, 128] (row stride 128, batch
// and head strides given); ks / vs f32 [B, Hkv, S]; out bf16 [B, Hq, 128].
// A (b, h) with no valid slot gives 0.
//
// Bound on an H100: device-memory bytes (the int8 K and V rows up to
// write_index and their scales, ~1.5 MB per layer at B 2, Hkv 4, 700 slots),
// but at that size the cost is latency: how soon all the bytes are in
// flight, and how many passes and launches the step takes. Design: ONE
// launch, one thread-block cluster of C blocks per (b, h):
//   * rank r takes the r-th contiguous share of the valid window
//     [pad[b], write_index] (read from device memory, so no host value per
//     step); the share is mirrored by ops/cuda_attention.attn_shares;
//   * before computing, thread 0 issues the rank's whole K slab and V slab
//     as two 1-D TMA bulk copies (cp.async.bulk) against two mbarriers, and
//     the threads load the scales meanwhile; a share longer than the
//     shared-memory stage is walked in stages (K for the scores, then V);
//   * 8 lanes per slot read one 128-byte K row from shared memory (16 bytes
//     each), the G dot products reduce over 3 shuffles;
//   * rank-local (max, sum) per query head by warp shuffles, pushed to every
//     rank by distributed shared memory stores; after a cluster barrier each
//     rank knows the global (M, L) and rounds p = exp(s - M) / L * vs to bf16
//     before the PV sum: the rounding point of the plain version and of JAX;
//   * each rank pushes its partial output to the rank that owns that slice
//     of the G x 128 outputs; after a second barrier the owner adds them in
//     rank order and writes bf16: deterministic, no atomics, no workspace in
//     device memory, and no rank reads another's shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 128;
constexpr int MAXG = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int HEAD_BYTES = 2048;  // barriers and per-head scalars, before the slabs

struct Head {
    unsigned long long kbar, vbar;    // mbarriers of the K and V bulk copies
    float m[MAXG];                    // this rank's max per query head
    float M[MAXG], L[MAXG];           // the cluster's max and sum
    float wred[WARPS][MAXG];          // one value per warp and head
    float2 ml[MAX_CLUSTER][MAXG];     // (max, sum) per rank and head, pushed by each rank
};
static_assert(sizeof(Head) <= HEAD_BYTES, "Head must fit before the slabs");

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// rows x 128 bytes from global to shared, one bulk copy completing on bar.
__device__ __forceinline__ void load_rows(int8_t* dst, const int8_t* src, int rows, uint32_t bar)
{
    const uint32_t bytes = static_cast<uint32_t>(rows) * DH;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Four int8 in a word → exact floats: 2^23 + (x + 128) built bytewise, minus 2^23 + 128.
__device__ __forceinline__ void unpack4(uint32_t w, float* f)
{
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | j)) - 8388736.f;
}

template <int GM>  // GM >= G: query heads held in registers
__global__ void __launch_bounds__(THREADS)
attn_cluster(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
             const float* __restrict__ ks, const int8_t* __restrict__ vq,
             const float* __restrict__ vs, long long kv_sb, long long kv_sh,
             long long sc_sb, long long sc_sh, const int* __restrict__ write_index,
             const int* __restrict__ pad, const int* __restrict__ gap_len, int gap_start,
             __nv_bfloat16* __restrict__ out, int Hkv, int G, int S, int share_cap, int stage,
             float sm_scale)
{
    extern __shared__ __align__(128) unsigned char smem[];
    // Remote ranks write into ml and recv: arrive now, wait before the first such write.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    Head& hd = *reinterpret_cast<Head*>(smem);
    int8_t* kbuf = reinterpret_cast<int8_t*>(smem + HEAD_BYTES);  // [stage][DH]
    int8_t* vbuf = kbuf + (size_t)stage * DH;                       // [stage][DH]
    float* sc = reinterpret_cast<float*>(vbuf + (size_t)stage * DH);  // [G][share_cap]: scores, then bf16(p * vs)
    float* ksh = sc + (size_t)G * share_cap;                        // [share_cap]
    float* vsh = ksh + share_cap;                                   // [share_cap]
    float* opart = vsh + share_cap;                                 // [G][DH]: this rank's partial output
    float* recv = opart + G * DH;                                   // [C][slice]: partials of this rank's slice

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int C = (int)cluster.num_blocks();
    const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // This rank's share of the valid window (mirrored by attn_shares in Python).
    const int lo = max(pad[b], 0);
    const int hi = min(*write_index + 1, S);
    const int share = hi > lo ? (hi - lo + C - 1) / C : 0;
    const int s0 = lo + rank * share;
    const int n = max(0, min(hi, s0 + share) - s0);
    const int nst = (n + stage - 1) / stage;
    const int gs = gap_start, ge = gap_start + (gap_len ? gap_len[b] : 0);

    const int8_t* kbase = kq + b * kv_sb + h * kv_sh + (size_t)s0 * DH;
    const int8_t* vbase = vq + b * kv_sb + h * kv_sh + (size_t)s0 * DH;
    const uint32_t kbar = smem_u32(&hd.kbar), vbar = smem_u32(&hd.vbar);
    if (tid == 0) {
        mbar_init(kbar);
        mbar_init(vbar);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        if (n > 0) {  // the first K and V stage at once; a rank past write_index loads nothing
            load_rows(kbuf, kbase, min(n, stage), kbar);
            load_rows(vbuf, vbase, min(n, stage), vbar);
        }
    }
    const float* ksb = ks + b * sc_sb + h * sc_sh + s0;
    const float* vsb = vs + b * sc_sb + h * sc_sh + s0;
    for (int j = tid; j < n; j += THREADS) {
        ksh[j] = ksb[j];
        vsh[j] = vsb[j];
    }

    // Lane group sub (8 lanes) takes one slot; lane c holds dims [16c, 16c + 16).
    const int sub = lane >> 3, c = lane & 7;
    float qr[GM][16];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        if (g < G) {
            const uint4* qp = reinterpret_cast<const uint4*>(q + ((size_t)bh * G + g) * DH + 16 * c);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const uint4 u = qp[half];
                const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
                    qr[g][8 * half + 2 * i] = f.x;
                    qr[g][8 * half + 2 * i + 1] = f.y;
                }
            }
        } else {
#pragma unroll
            for (int i = 0; i < 16; ++i) qr[g][i] = 0.f;
        }
    }
    __syncthreads();  // barriers initialised, scales in shared memory

    // Scores, stage by stage over K.
    uint32_t kphase = 0, vphase = 0;
    for (int st = 0; st < nst; ++st) {
        const int j0 = st * stage, rows = min(stage, n - j0);
        if (st > 0) {
            __syncthreads();  // every thread is done with the previous K stage
            if (tid == 0) load_rows(kbuf, kbase + (size_t)j0 * DH, rows, kbar);
        }
        mbar_wait(kbar, kphase);
        kphase ^= 1;
        for (int jb = warp * 4; jb < rows; jb += WARPS * 4) {  // uniform per warp: shuffles stay full
            const int jj = jb + sub;
            const bool in = jj < rows;
            const uint4 kv = in ? *reinterpret_cast<const uint4*>(kbuf + (size_t)jj * DH + 16 * c)
                                : make_uint4(0u, 0u, 0u, 0u);
            float kf[16];
            unpack4(kv.x, kf);
            unpack4(kv.y, kf + 4);
            unpack4(kv.z, kf + 8);
            unpack4(kv.w, kf + 12);
            float mine = 0.f;
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                float d = 0.f;
#pragma unroll
                for (int i = 0; i < 16; ++i) d = fmaf(qr[g][i], kf[i], d);
                d += __shfl_xor_sync(0xffffffffu, d, 4);
                d += __shfl_xor_sync(0xffffffffu, d, 2);
                d += __shfl_xor_sync(0xffffffffu, d, 1);
                if (g == c) mine = d;
            }
            if (in && c < G) {
                const int j = j0 + jj, s = s0 + j;
                const bool valid = !(s >= gs && s < ge);
                sc[c * share_cap + j] = valid ? mine * ksh[j] * sm_scale : -CUDART_INF_F;
            }
        }
    }
    __syncthreads();

    // Rank-local max, then sum of exp(s - max), per query head.
    float red[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) red[g] = -CUDART_INF_F;
    for (int j = tid; j < n; j += THREADS)
#pragma unroll
        for (int g = 0; g < GM; ++g)
            if (g < G) red[g] = fmaxf(red[g], sc[g * share_cap + j]);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) red[g] = fmaxf(red[g], __shfl_xor_sync(0xffffffffu, red[g], off));
        if (lane == 0) hd.wred[warp][g] = red[g];
    }
    __syncthreads();
    if (tid < G) {
        float m = -CUDART_INF_F;
        for (int w = 0; w < WARPS; ++w) m = fmaxf(m, hd.wred[w][tid]);
        hd.m[tid] = m;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) red[g] = 0.f;
    for (int j = tid; j < n; j += THREADS)
#pragma unroll
        for (int g = 0; g < GM; ++g)
            if (g < G) {
                const float s = sc[g * share_cap + j];
                if (s != -CUDART_INF_F) red[g] += expf(s - hd.m[g]);
            }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) red[g] += __shfl_xor_sync(0xffffffffu, red[g], off);
        if (lane == 0) hd.wred[warp][g] = red[g];
    }
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
    if (tid < G) {  // push this rank's (m, l) to every rank
        float l = 0.f;
        for (int w = 0; w < WARPS; ++w) l += hd.wred[w][tid];
        const float2 ml = make_float2(hd.m[tid], l);
        for (int r = 0; r < C; ++r) cluster.map_shared_rank(&hd, r)->ml[rank][tid] = ml;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

    // The cluster's (M, L): lane r of warp 0 takes rank r's (m, l).
    if (warp == 0) {
        for (int g = 0; g < G; ++g) {
            float mr = -CUDART_INF_F, lr = 0.f;
            if (lane < C) {
                mr = hd.ml[lane][g].x;
                lr = hd.ml[lane][g].y;
            }
            float M = mr;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
            float w = (mr == -CUDART_INF_F) ? 0.f : lr * expf(mr - M);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) w += __shfl_xor_sync(0xffffffffu, w, off);
            if (lane == 0) {
                hd.M[g] = M;
                hd.L[g] = w;
            }
        }
    }
    __syncthreads();

    // Normalise, then round p * vs to bf16 (q's dtype), in place.
    for (int idx = tid; idx < G * n; idx += THREADS) {
        const int g = idx / n, j = idx - g * n;
        const float s = sc[g * share_cap + j];
        const float p = (s == -CUDART_INF_F) ? 0.f : expf(s - hd.M[g]) / hd.L[g];
        sc[g * share_cap + j] = __bfloat162float(__float2bfloat16(p * vsh[j]));
    }

    // PV sum, stage by stage over V: thread (d, half) takes every other slot.
    const int d = tid & (DH - 1), half = tid >> 7;
    float acc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) acc[g] = 0.f;
    for (int st = 0; st < nst; ++st) {
        const int j0 = st * stage, rows = min(stage, n - j0);
        __syncthreads();  // the weights are written; the previous V stage is read
        if (st > 0 && tid == 0) load_rows(vbuf, vbase + (size_t)j0 * DH, rows, vbar);
        mbar_wait(vbar, vphase);
        vphase ^= 1;
#pragma unroll 4
        for (int jj = half; jj < rows; jj += 2) {
            const float v = (float)vbuf[(size_t)jj * DH + d];
#pragma unroll
            for (int g = 0; g < GM; ++g)
                if (g < G) acc[g] = fmaf(sc[g * share_cap + j0 + jj], v, acc[g]);
        }
    }
    __syncthreads();
    if (half == 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
            if (g < G) opart[g * DH + d] = acc[g];
    __syncthreads();
    if (half == 0)
#pragma unroll
        for (int g = 0; g < GM; ++g)
            if (g < G) opart[g * DH + d] = acc[g] + opart[g * DH + d];
    __syncthreads();

    // Rank r owns outputs [r * slice, (r + 1) * slice) of the G x DH: every rank
    // pushes its partials there, and the owner adds them in rank order.
    const int slice = (G * DH + C - 1) / C;
    for (int idx = tid; idx < G * DH; idx += THREADS) {
        const int owner = idx / slice;
        cluster.map_shared_rank(recv, owner)[rank * slice + (idx - owner * slice)] = opart[idx];
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    for (int i = tid; i < slice && rank * slice + i < G * DH; i += THREADS) {
        float s = 0.f;
        for (int r = 0; r < C; ++r) s += recv[r * slice + i];
        out[(size_t)bh * G * DH + rank * slice + i] = __float2bfloat16(s);
    }
}

template <int GM>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           long long kv_sb, long long kv_sh, long long sc_sb, long long sc_sh,
           const void* write_index, const void* pad, const void* gap_len, int gap_start, void* out,
           int B, int Hkv, int G, int S, int cluster, int share_cap, int stage, int smem_bytes,
           float sm_scale, cudaStream_t st)
{
    static bool configured = false;  // attributes are per kernel, set once
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(attn_cluster<GM>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(attn_cluster<GM>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, B * Hkv, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, attn_cluster<GM>, static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const float*>(ks), static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
        kv_sb, kv_sh, sc_sb, sc_sh, static_cast<const int*>(write_index), static_cast<const int*>(pad),
        static_cast<const int*>(gap_len), gap_start, static_cast<__nv_bfloat16*>(out), Hkv, G, S, share_cap,
        stage, sm_scale);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// share_cap >= ceil(S / cluster) slots, stage <= share_cap slots per bulk copy,
// smem_bytes as ops/cuda_attention.attn_plan lays it out.
extern "C" int zt_attn_core_int8(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, long long kv_sb, long long kv_sh,
                                 long long sc_sb, long long sc_sh, const void* write_index,
                                 const void* pad, const void* gap_len, int gap_start, void* out,
                                 int B, int Hkv, int G, int S, int cluster, int share_cap, int stage,
                                 int smem_bytes, float sm_scale, void* stream)
{
    if (G < 1 || G > MAXG || cluster < 1 || cluster > MAX_CLUSTER || stage < 1 ||
        (long long)share_cap * cluster < S || stage > share_cap)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (G <= 4)
        return launch<4>(q, kq, ks, vq, vs, kv_sb, kv_sh, sc_sb, sc_sh, write_index, pad, gap_len, gap_start,
                         out, B, Hkv, G, S, cluster, share_cap, stage, smem_bytes, sm_scale, st);
    return launch<8>(q, kq, ks, vq, vs, kv_sb, kv_sh, sc_sb, sc_sh, write_index, pad, gap_len, gap_start,
                     out, B, Hkv, G, S, cluster, share_cap, stage, smem_bytes, sm_scale, st);
}
