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

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TN = 256;           // columns per block
constexpr int THREADS = 512;
constexpr int CPT = 4;            // columns per thread
constexpr int CG = TN / CPT;      // column groups: 64
constexpr int KG = THREADS / CG;  // row groups: 8
constexpr int SK = 128;           // rows per ring slot: one TMA box [SK, TN]
constexpr int NS = 3;             // ring slots at most
constexpr int MAX_CLUSTER = 16;
constexpr int BAR_BYTES = 128;    // the slots' mbarriers, before the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Four int8 in a word → exact floats: 2^23 + (x + 128) built bytewise, minus 2^23 + 128.
__device__ __forceinline__ void unpack4(uint32_t w, float* f)
{
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | j)) - 8388736.f;
}

template <int RB>
__device__ __forceinline__ void load_x(const float* p, float* xv)
{
    if constexpr (RB == 1) {
        xv[0] = p[0];
    } else if constexpr (RB == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        xv[0] = v.x;
        xv[1] = v.y;
    } else {
#pragma unroll
        for (int i = 0; i < RB; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(p + i);
            xv[i] = v.x;
            xv[i + 1] = v.y;
            xv[i + 2] = v.z;
            xv[i + 3] = v.w;
        }
    }
}

// RB: rows of x padded to 1, 2, 4, 8 or 16. VEC: TMA copies (row stride and
// base 16-byte aligned) or byte loads. kc: K rows per rank; per: columns each
// rank reduces.
template <int RB, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemv_cluster(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w, long long ldw, const float* __restrict__ scale,
                  float* __restrict__ y, int B, int K, int N, int kc, int per)
{
    extern __shared__ __align__(128) unsigned char smem[];
    // Remote ranks write into recv below: arrive now, wait before the first such write.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int C = (int)cluster.num_blocks();
    const int tid = threadIdx.x;
    const int n0 = blockIdx.y * TN;
    const int k_begin = min(K, rank * kc);
    const int rows = min(K, k_begin + kc) - k_begin;
    const int nstages = (rows + SK - 1) / SK;
    const int slots = min(NS, (kc + SK - 1) / SK);

    // [mbarriers][ring [slots][SK][TN] int8, later red [KG][RB][TN] f32]
    // [xs [kc][RB] f32][recv [C][B][per] f32]
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
    const size_t ring_bytes = max((size_t)slots * SK * TN, (size_t)KG * RB * TN * sizeof(float));
    int8_t* ring = reinterpret_cast<int8_t*>(smem + BAR_BYTES);
    float* red = reinterpret_cast<float*>(ring);
    float* xs = reinterpret_cast<float*>(smem + BAR_BYTES + ring_bytes);
    float* recv = xs + (size_t)kc * RB;

    // Thread 0 issues stage st into its slot: the whole [SK, 256] box (rows
    // past K and columns past N arrive as zeros and count as bytes).
    auto issue = [&](int st) {
        const uint32_t bar = smem_u32(&bars[st % slots]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar), "r"((uint32_t)(SK * TN)) : "memory");
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
            ::"r"(smem_u32(ring + (size_t)(st % slots) * SK * TN)), "l"(reinterpret_cast<uint64_t>(&wmap)),
              "r"(n0), "r"(k_begin + st * SK), "r"(bar) : "memory");
    };
    auto fill = [&](int st) {  // the scalar variant: every thread loads bytes
        int8_t* dst = ring + (size_t)(st % slots) * SK * TN;
        const int r0 = k_begin + st * SK, nr = min(SK, k_begin + rows - r0);
        for (int idx = tid; idx < nr * TN; idx += THREADS) {
            const int r = idx / TN, col = idx - r * TN;
            dst[idx] = n0 + col < N ? w[(size_t)(r0 + r) * ldw + n0 + col] : (int8_t)0;
        }
    };

    if (VEC && tid == 0) {
        for (int i = 0; i < slots; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&bars[i])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int st = 0; st < min(nstages, slots); ++st) issue(st);
    }
    // The scale of the first output column this thread writes, fetched early.
    const int c_lo = rank * per, ncols = max(0, min(TN, c_lo + per) - c_lo);
    const float scale0 = tid < B * ncols && n0 + c_lo + tid % ncols < N ? scale[n0 + c_lo + tid % ncols] : 0.f;

    // x's slab, rows past B zero (thread 0's warp issues the copies and stays out of it).
    for (int idx = tid - 32; idx < RB * rows; idx += THREADS - 32) {
        if (idx < 0) break;
        const int b = idx / rows, k = idx - b * rows;
        xs[k * RB + b] = b < B ? __bfloat162float(x[(size_t)b * K + k_begin + k]) : 0.f;
    }
    __syncthreads();  // xs written, barriers initialised

    const int cgi = tid % CG, kgi = tid / CG;
    float acc[RB][CPT];
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[b][j] = 0.f;

    for (int st = 0; st < nstages; ++st) {
        if (VEC) {
            mbar_wait(smem_u32(&bars[st % slots]), (uint32_t)(st / slots) & 1u);
        } else {
            fill(st);
            __syncthreads();
        }
        const int8_t* src = ring + (size_t)(st % slots) * SK * TN + cgi * CPT;
        const int r0 = st * SK, nr = min(SK, rows - r0);
#pragma unroll
        for (int i = 0; i < SK / KG; ++i) {
            const int r = kgi + i * KG;
            if (r < nr) {
                float wf[CPT], xv[RB];
                unpack4(*reinterpret_cast<const uint32_t*>(src + r * TN), wf);
                load_x<RB>(xs + (size_t)(r0 + r) * RB, xv);
#pragma unroll
                for (int b = 0; b < RB; ++b)
#pragma unroll
                    for (int j = 0; j < CPT; ++j) acc[b][j] = fmaf(xv[b], wf[j], acc[b][j]);
            }
        }
        if (!VEC || st + slots < nstages) {
            __syncthreads();  // the slot is read: refill it
            if (VEC && tid == 0) issue(st + slots);
        }
    }
    __syncthreads();  // every slot read: the ring becomes red

    // The block's 8 row groups; their sum for column col goes to the rank that owns col.
#pragma unroll
    for (int b = 0; b < RB; ++b)
        *reinterpret_cast<float4*>(red + ((size_t)kgi * RB + b) * TN + cgi * CPT) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
    for (int idx = tid; idx < B * TN; idx += THREADS) {
        const int b = idx / TN, col = idx - b * TN, owner = col / per;
        float s = red[idx];
#pragma unroll
        for (int g = 1; g < KG; ++g) s += red[(size_t)g * RB * TN + idx];
        cluster.map_shared_rank(recv, owner)[((size_t)rank * B + b) * per + (col - owner * per)] = s;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

    // This rank's columns: the ranks' sums in rank order, the scale once.
    for (int idx = tid; idx < B * ncols; idx += THREADS) {
        const int b = idx / ncols, c = idx - b * ncols, n = n0 + c_lo + c;
        if (n < N) {
            float s = 0.f;
            for (int r = 0; r < C; ++r) s += recv[((size_t)r * B + b) * per + c];
            y[(size_t)b * N + n] = s * (idx == tid ? scale0 : scale[n]);
        }
    }
}

// Tensor maps of the weights seen so far, by (address, K, N, row stride): a
// map describes only those, so a cached one is always right.
struct MapEntry {
    const void* w;
    long long ldw;
    int K, N;
    CUtensorMap map;
};
MapEntry g_maps[256];
int g_nmaps = 0, g_next = 0;

int weight_map(const void* w, long long ldw, int K, int N, CUtensorMap* out)
{
    for (int i = 0; i < g_nmaps; ++i) {
        const MapEntry& e = g_maps[i];
        if (e.w == w && e.ldw == ldw && e.K == K && e.N == N) {
            *out = e.map;
            return 0;
        }
    }
    static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
    if (!encode) {
        cudaDriverEntryPointQueryResult q;
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                                      cudaEnableDefault, &q);
        if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !encode) {
            encode = nullptr;
            return (int)cudaErrorNotSupported;
        }
    }
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)ldw};
    const cuuint32_t box[2] = {(cuuint32_t)TN, (cuuint32_t)SK};
    const cuuint32_t estr[2] = {1, 1};
    MapEntry& e = g_maps[g_next];
    if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    e.w = w;
    e.ldw = ldw;
    e.K = K;
    e.N = N;
    *out = e.map;
    g_next = (g_next + 1) % 256;
    g_nmaps = g_nmaps < 256 ? g_nmaps + 1 : 256;
    return 0;
}

template <int RB, bool VEC>
int launch(const void* x, const void* w, long long ldw, const void* scale, void* y, int B, int K, int N,
           int cluster, int kc, int smem_bytes, cudaStream_t st)
{
    CUtensorMap wmap = {};
    if (VEC) {
        const int err = weight_map(w, ldw, K, N, &wmap);
        if (err) return err;
    }
    static bool configured = false;  // attributes are per kernel, set once
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(int8_gemv_cluster<RB, VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(int8_gemv_cluster<RB, VEC>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, (N + TN - 1) / TN, 1);
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
    const int per = (TN + cluster - 1) / cluster;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, int8_gemv_cluster<RB, VEC>, wmap,
                                             static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                                             ldw, static_cast<const float*>(scale), static_cast<float*>(y),
                                             B, K, N, kc, per);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <int RB>
int launch_rb(bool vec, const void* x, const void* w, long long ldw, const void* scale, void* y, int B, int K,
              int N, int cluster, int kc, int smem_bytes, cudaStream_t st)
{
    return vec ? launch<RB, true>(x, w, ldw, scale, y, B, K, N, cluster, kc, smem_bytes, st)
               : launch<RB, false>(x, w, ldw, scale, y, B, K, N, cluster, kc, smem_bytes, st);
}

}  // namespace

// cluster K ranks of kc rows each (cluster * kc >= K), smem_bytes as
// ops/cuda_matmul.int8_matmul_plan lays it out.
extern "C" int zt_int8_matmul(const void* x, const void* wq, long long ldw, const void* scale, void* y,
                              int B, int K, int N, int cluster, int kc, int smem_bytes, void* stream)
{
    if (B < 1 || B > 16 || cluster < 1 || cluster > MAX_CLUSTER || (long long)cluster * kc < K || ldw < N)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const bool vec = ldw % 16 == 0 && (reinterpret_cast<uintptr_t>(wq) & 15) == 0;
    if (B == 1) return launch_rb<1>(vec, x, wq, ldw, scale, y, B, K, N, cluster, kc, smem_bytes, st);
    if (B == 2) return launch_rb<2>(vec, x, wq, ldw, scale, y, B, K, N, cluster, kc, smem_bytes, st);
    if (B <= 4) return launch_rb<4>(vec, x, wq, ldw, scale, y, B, K, N, cluster, kc, smem_bytes, st);
    if (B <= 8) return launch_rb<8>(vec, x, wq, ldw, scale, y, B, K, N, cluster, kc, smem_bytes, st);
    return launch_rb<16>(vec, x, wq, ldw, scale, y, B, K, N, cluster, kc, smem_bytes, st);
}

