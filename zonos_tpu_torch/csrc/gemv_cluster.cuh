// Pieces shared by the cluster GEMV kernels: K1 (int8_matmul.cu), K3
// (fused_mlp_int8.cu, whose fc2 is K1's body below) and K4 (int4_matmul.cu).
//
//   * shared-memory addresses, mbarrier set-up and waits, 2-D TMA box copies;
//   * the tensor-map cache: maps of the weights seen so far, encoded once on
//     the host (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint);
//   * int8_gemv_cluster, K1's body: y = (x · w) · s for 1-32 rows of x, split-K
//     reduced inside a thread-block cluster (see int8_matmul.cu's head). With
//     PDL set it is launched as a programmatic dependent of the kernel before
//     it: it issues its weight copies first and waits for that kernel
//     (griddepcontrol.wait) only before it reads x.
//
// Everything here has internal linkage (an unnamed namespace): each kernel
// library is its own shared object, and a function-local static of an inline
// function (the "attributes set" flags, the map cache) would otherwise be one
// process-wide object for all of them, so a second library would skip
// setting its own kernel's attributes and fail to launch it.
//
// The host state here (the map cache, the "attributes set" flags) is written
// under host_mutex: the Python wrappers call in through ctypes, which releases
// the GIL, so two threads of a server can be inside a library at once.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace zt {
namespace {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 16;    // the non-portable cluster limit
constexpr int BAR_BYTES = 128;     // room for the ring's mbarriers, before the ring
constexpr int MAX_SMEM = 232448;   // 227 KB, what one block may use on an H100

std::mutex host_mutex;  // guards this library's host state: the map cache and the attribute flags

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_fence_init()
{
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// The barrier expects `bytes` more; one thread arrives.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// One 2-D box of `map` at (column c, row r) into dst, completing on bar.
// Rows and columns past the map's extent arrive as zeros and count as bytes.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c, int r, uint32_t bar)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar) : "memory");
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

// A 2-D uint8 tensor map of w [rows, cols] (row stride ld bytes) in boxes of
// [box_rows, box_cols]. Maps are cached by everything they encode, so a
// cached one is always right; the cache holds the last 256.
inline int weight_map(const void* w, long long ld, int rows, int cols, int box_cols, int box_rows, CUtensorMap* out)
{
    struct Entry {
        const void* w;
        long long ld;
        int rows, cols, box_cols, box_rows;
        CUtensorMap map;
    };
    const std::lock_guard<std::mutex> lock(host_mutex);
    static Entry maps[256];
    static int count = 0, next = 0;
    for (int i = 0; i < count; ++i) {
        const Entry& e = maps[i];
        if (e.w == w && e.ld == ld && e.rows == rows && e.cols == cols && e.box_cols == box_cols &&
            e.box_rows == box_rows) {
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
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)ld};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t estr[2] = {1, 1};
    Entry& e = maps[next];
    if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    e.w = w;
    e.ld = ld;
    e.rows = rows;
    e.cols = cols;
    e.box_cols = box_cols;
    e.box_rows = box_rows;
    *out = e.map;
    next = (next + 1) % 256;
    count = count < 256 ? count + 1 : 256;
    return 0;
}

// Set a kernel's dynamic shared memory limit and non-portable clusters once.
template <typename Kernel>
inline int configure_once(Kernel kernel, bool& done)
{
    const std::lock_guard<std::mutex> lock(host_mutex);
    if (done) return 0;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    done = true;
    return 0;
}

// ---------------------------------------------------------------------------
// K1's body: the int8 GEMV with split-K reduced inside the cluster
// ---------------------------------------------------------------------------

namespace k1 {
constexpr int TN = 256;           // columns per block
constexpr int THREADS = 512;
constexpr int CPT = 4;            // columns per thread
constexpr int CG = TN / CPT;      // column groups: 64
constexpr int SK = 128;           // rows per ring slot: one TMA box [SK, TN]

// A thread sums RT = min(RB, 16) rows of x: at RB 32 the block's threads
// form two halves (rows 0-15 and 16-31), each with 4 row groups, else one
// of 8. Either way the row groups' sums [KG][RB][TN] take 128 KB at most.
template <int RB>
struct Geom {
    static constexpr int RT = RB < 16 ? RB : 16;
    static constexpr int KG = THREADS / (CG * (RB / RT));
};
}  // namespace k1

// RB: rows of x padded to 1, 2, 4, 8, 16 or 32. VEC: TMA copies (row stride
// and base 16-byte aligned) or byte loads. kc: K rows per rank; per: columns
// each rank reduces; max_slots: ring slots at most.
template <int RB, bool VEC, bool PDL>
__global__ void __launch_bounds__(k1::THREADS, PDL && RB <= 4 ? 2 : 1)
int8_gemv_cluster(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w, long long ldw, const float* __restrict__ scale,
                  float* __restrict__ y, int B, int K, int N, int kc, int per, int max_slots)
{
    using namespace k1;
    constexpr int RT = Geom<RB>::RT, KG = Geom<RB>::KG;
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
    const int slots = min(max_slots, (kc + SK - 1) / SK);

    // [mbarriers][ring [slots][SK][TN] int8, later red [KG][RB][TN] f32]
    // [xs [kc][RB] f32][recv [C][B][per] f32]
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
    const size_t ring_bytes = max((size_t)slots * SK * TN, (size_t)KG * RB * TN * sizeof(float));
    int8_t* ring = reinterpret_cast<int8_t*>(smem + BAR_BYTES);
    float* red = reinterpret_cast<float*>(ring);
    float* xs = reinterpret_cast<float*>(smem + BAR_BYTES + ring_bytes);
    float* recv = xs + (size_t)kc * RB;

    // Thread 0 issues stage st into its slot: the whole [SK, 256] box.
    auto issue = [&](int st) {
        const uint32_t bar = smem_u32(&bars[st % slots]);
        mbar_expect(bar, (uint32_t)(SK * TN));
        tma_box(ring + (size_t)(st % slots) * SK * TN, &wmap, n0, k_begin + st * SK, bar);
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
        for (int i = 0; i < slots; ++i) mbar_init(smem_u32(&bars[i]));
        mbar_fence_init();
        for (int st = 0; st < min(nstages, slots); ++st) issue(st);
    }
    // The scale of the first output column this thread writes, fetched early.
    const int c_lo = rank * per, ncols = max(0, min(TN, c_lo + per) - c_lo);
    const float scale0 = tid < B * ncols && n0 + c_lo + tid % ncols < N ? scale[n0 + c_lo + tid % ncols] : 0.f;
    if (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");  // x is the previous kernel's output

    // x's slab, rows past B zero (thread 0's warp issues the copies and stays out of it).
    for (int idx = tid - 32; idx < RB * rows; idx += THREADS - 32) {
        if (idx < 0) break;
        const int b = idx / rows, k = idx - b * rows;
        xs[k * RB + b] = b < B ? __bfloat162float(x[(size_t)b * K + k_begin + k]) : 0.f;
    }
    __syncthreads();  // xs written, barriers initialised

    const int cgi = tid % CG, kgi = (tid / CG) % KG, b0 = tid / (CG * KG) * RT;
    float acc[RT][CPT];
#pragma unroll
    for (int b = 0; b < RT; ++b)
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
                float wf[CPT], xv[RT];
                unpack4(*reinterpret_cast<const uint32_t*>(src + r * TN), wf);
                load_x<RT>(xs + (size_t)(r0 + r) * RB + b0, xv);
#pragma unroll
                for (int b = 0; b < RT; ++b)
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

    // The block's row groups; their sum for column col goes to the rank that owns col.
#pragma unroll
    for (int b = 0; b < RT; ++b)
        *reinterpret_cast<float4*>(red + ((size_t)kgi * RB + b0 + b) * TN + cgi * CPT) =
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

template <int RB, bool VEC, bool PDL>
int launch_gemv_rb(const void* x, const void* w, long long ldw, const void* scale, void* y, int B, int K, int N,
                   int cluster, int kc, int max_slots, int smem_bytes, cudaStream_t st)
{
    CUtensorMap wmap = {};
    if (VEC) {
        const int err = weight_map(w, ldw, K, N, k1::TN, k1::SK, &wmap);
        if (err) return err;
    }
    static bool configured = false;  // attributes are per kernel, set once
    const int err = configure_once(int8_gemv_cluster<RB, VEC, PDL>, configured);
    if (err) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, (N + k1::TN - 1) / k1::TN, 1);
    cfg.blockDim = dim3(k1::THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = PDL ? 2 : 1;
    const int per = (k1::TN + cluster - 1) / cluster;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, int8_gemv_cluster<RB, VEC, PDL>, wmap,
                                             static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                                             ldw, static_cast<const float*>(scale), static_cast<float*>(y),
                                             B, K, N, kc, per, max_slots);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// K1's launch for any B in 1..32 (cluster K ranks of kc rows each, the ring
// at most max_slots slots, smem_bytes as ops/cuda_matmul.int8_matmul_plan
// lays it out). PDL: launch as a programmatic dependent (TMA path only).
template <bool PDL>
int launch_gemv(const void* x, const void* w, long long ldw, const void* scale, void* y, int B, int K, int N,
                int cluster, int kc, int max_slots, int smem_bytes, cudaStream_t st)
{
    if (B < 1 || B > 32 || cluster < 1 || cluster > MAX_CLUSTER || (long long)cluster * kc < K || ldw < N)
        return (int)cudaErrorInvalidValue;
    const bool vec = ldw % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    if (PDL && !vec) return (int)cudaErrorInvalidValue;
#define ZT_GEMV(RB)                                                                                         \
    (vec ? launch_gemv_rb<RB, true, PDL>(x, w, ldw, scale, y, B, K, N, cluster, kc, max_slots, smem_bytes, st) \
         : launch_gemv_rb<RB, false, false>(x, w, ldw, scale, y, B, K, N, cluster, kc, max_slots, smem_bytes, st))
    if (B == 1) return ZT_GEMV(1);
    if (B == 2) return ZT_GEMV(2);
    if (B <= 4) return ZT_GEMV(4);
    if (B <= 8) return ZT_GEMV(8);
    if (B <= 16) return ZT_GEMV(16);
    return ZT_GEMV(32);
#undef ZT_GEMV
}

}  // namespace
}  // namespace zt
