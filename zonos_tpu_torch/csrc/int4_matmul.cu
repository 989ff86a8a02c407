// K4: group-wise int4 weight-only GEMV for the decode projections.
//
// Replaces the TPU kernel zonos_tpu/ops/pallas_matmul.py::int4_matmul (body
// _int4_kernel): y[b, n] = sum_g s4[g, n] * sum_{k in group g} x[b, k] * w[k, n]
// with x bf16 [B, K], 1 <= B <= 32, y f32 [B, N], and w packed two weights to
// a byte: q4 uint8 [G, group/2, N], where byte (g, j, n) holds row
// g*group + j in its low nibble and row g*group + j + group/2 in its high
// nibble, both two's complement; s4 f32 [G, N] (one scale per group and
// output column).
//
// Bound on an H100: device-memory bytes, K*N/2 of packed weight plus G*N*4
// of scales (3.3 MB at in_proj, 2048 -> 3072, group 128), against KBs of x.
// A decode GEMV has few column tiles, so K is split too. Design: K1's
// (int8_matmul.cu), adapted to nibbles. ONE launch, grid (K ranks, column
// tiles of 256); the K ranks of a tile form one thread-block cluster of at
// most 16, and each rank owns whole groups (ops/cuda_matmul.int4_matmul_plan):
//   * one thread streams the rank's packed rows into a ring of up to 8 slots
//     in shared memory, one 2-D TMA box (a group: [group/2, 256] bytes of a
//     tensor map of the packed [K/2, N] view) per slot, each completing on
//     the slot's mbarrier; at the main-path shapes the whole slab is in
//     flight at once while the other warps stage x (f32, k-major, every B
//     row padded to 1, 2, 4, 8, 16 or 32) and the rank's scales [groups, 256]
//     in shared memory. B up to 32 reads the weight once;
//   * a thread takes 4 columns (one 32-bit word of a packed row) and every
//     KG-th packed row of a group, unpacks both nibbles of each byte to exact
//     floats (mask, xor 8, byte permute into 2^23 + v + 8), sums x * q of its
//     rows of the group in f32 for all B rows, and multiplies that sum by the
//     group's f32 scale once before adding it to its total;
//   * the block adds its row groups, and each rank pushes its sums for the
//     columns that rank r owns into rank r's shared memory (distributed
//     shared memory stores); after one cluster barrier rank r adds the
//     ranks' sums in rank order and writes y: deterministic, no atomics, no
//     partial buffer in device memory, nothing allocated but y.
// The packed view's row stride (N bytes) and base must be 16-byte aligned
// for a tensor map; the wrapper refuses other layouts (every main-path N is
// a multiple of 16). A thread keeps sums for at most 8 rows of x, so at
// B 16 the 512 threads form two halves of 4 row groups, one per 8 rows, and
// at B 32 four quarters of 2 row groups.
// The TPU kernel rounds the dequantized weight to bf16 before its dot; here
// the scale multiplies exact f32 sums, the form of the JAX package's XLA path
// (ops/quant.py::q4einsum_lastdim).
//
// Replaced, and slower: PR 2's two-pass design (a partial pass over one group
// per block, at most 2 rows of x per pass, 16-byte __ldg loads and x and the
// scales read from global memory by every thread, then a reduce pass over a
// partial buffer in device memory). Tried in this structure and slower: K1's
// cluster rule (fill the SMs, which at fc1 makes two blocks share an SM),
// and 256 threads at B 16. What holds it back now is fixed latency (the
// first TMA bytes, staging, two cluster barriers) and, at fc2, 16 ranks that
// each wait for 4 groups: it stays slower there than PR 2's kernel.

#include "gemv_cluster.cuh"

namespace {

constexpr int TN = 256;      // columns per block
constexpr int CPT = 4;       // columns per thread: one 32-bit word of a packed row
constexpr int CG = TN / CPT; // column groups: 64
constexpr int MAX_SLOTS = 8; // ring slots at most (one group each)
constexpr int THREADS = 512;

// A thread sums RT = min(RB, 8) rows of x; at B 16 the block's threads form
// two halves (rows 0-7 and 8-15), each with KG = 4 row groups, at B 32 four
// quarters with KG = 2, else KG = 8.
template <int RB>
struct Geom {
    static constexpr int RT = RB < 8 ? RB : 8;
    static constexpr int HALVES = RB / RT;
    static constexpr int KG = THREADS / (CG * HALVES);
};

// Four bytes → the 4 low nibbles and the 4 high nibbles as exact floats.
__device__ __forceinline__ void unpack_nibbles(uint32_t w, float* lo, float* hi)
{
    const uint32_t ul = (w & 0x0F0F0F0Fu) ^ 0x08080808u;         // v + 8 in each byte
    const uint32_t uh = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        lo[j] = __uint_as_float(__byte_perm(ul, 0x4B000000u, 0x7440u | j)) - 8388616.f;
        hi[j] = __uint_as_float(__byte_perm(uh, 0x4B000000u, 0x7440u | j)) - 8388616.f;
    }
}

// RB: rows of x padded to 1, 2, 4, 8, 16 or 32. half: packed rows per group
// (group / 2); gpr: groups per rank; per: columns each rank reduces.
template <int RB>
__global__ void __launch_bounds__(THREADS, 1)
int4_gemv_cluster(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ s4, float* __restrict__ y, int B, int K, int N, int half, int gpr,
                  int per, int max_slots)
{
    using namespace zt;
    constexpr int RT = Geom<RB>::RT, KG = Geom<RB>::KG;
    extern __shared__ __align__(128) unsigned char smem[];
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int C = (int)cluster.num_blocks();
    const int tid = threadIdx.x;
    const int n0 = blockIdx.y * TN;
    const int group = 2 * half;
    const int G = K / group;
    const int g0 = min(G, rank * gpr);
    const int ngroups = min(G, g0 + gpr) - g0;  // this rank's groups: its ring stages
    const int rows = ngroups * group;
    const int slots = min(max_slots, gpr);
    const int slot_bytes = half * TN;

    // [mbarriers][ring [slots][half][TN] uint8, later red [KG][RB][TN] f32]
    // [ss [gpr][TN] f32][xs [gpr * group][RB] f32][recv [C][B][per] f32]
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
    const size_t ring_bytes = max((size_t)slots * slot_bytes, (size_t)KG * RB * TN * sizeof(float));
    uint8_t* ring = smem + BAR_BYTES;
    float* red = reinterpret_cast<float*>(ring);
    float* ss = reinterpret_cast<float*>(smem + BAR_BYTES + ring_bytes);
    float* xs = ss + (size_t)gpr * TN;
    float* recv = xs + (size_t)gpr * group * RB;

    auto issue = [&](int st) {
        const uint32_t bar = smem_u32(&bars[st % slots]);
        mbar_expect(bar, (uint32_t)slot_bytes);
        tma_box(ring + (size_t)(st % slots) * slot_bytes, &wmap, n0, (g0 + st) * half, bar);
    };
    if (tid == 0) {
        for (int i = 0; i < slots; ++i) mbar_init(smem_u32(&bars[i]));
        mbar_fence_init();
        for (int st = 0; st < min(ngroups, slots); ++st) issue(st);
    }
    // x's rows and the scales of this rank's groups (thread 0's warp issues
    // the copies and stays out of it); rows past B are zero.
    for (int idx = tid - 32; idx < RB * rows; idx += THREADS - 32) {
        if (idx < 0) break;
        const int b = idx / rows, k = idx - b * rows;
        xs[k * RB + b] = b < B ? __bfloat162float(x[(size_t)b * K + (size_t)g0 * group + k]) : 0.f;
    }
    for (int idx = tid - 32; idx < ngroups * CG; idx += THREADS - 32) {
        if (idx < 0) break;
        const int g = idx / CG, c = (idx - g * CG) * CPT;
        *reinterpret_cast<float4*>(ss + g * TN + c) =
            n0 + c < N ? *reinterpret_cast<const float4*>(s4 + (size_t)(g0 + g) * N + n0 + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // xs and ss written, barriers initialised

    const int cgi = tid % CG, kgi = (tid / CG) % KG, b0 = tid / (CG * KG) * RT;
    float acc[RT][CPT];
#pragma unroll
    for (int b = 0; b < RT; ++b)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[b][j] = 0.f;

    for (int st = 0; st < ngroups; ++st) {
        mbar_wait(smem_u32(&bars[st % slots]), (uint32_t)(st / slots) & 1u);
        const uint8_t* src = ring + (size_t)(st % slots) * slot_bytes + cgi * CPT;
        const float* xg = xs + (size_t)st * group * RB;
        float gacc[RT][CPT];
#pragma unroll
        for (int b = 0; b < RT; ++b)
#pragma unroll
            for (int j = 0; j < CPT; ++j) gacc[b][j] = 0.f;
#pragma unroll 4
        for (int r = kgi; r < half; r += KG) {
            float lo[CPT], hi[CPT], xl[RT], xh[RT];
            unpack_nibbles(*reinterpret_cast<const uint32_t*>(src + r * TN), lo, hi);
            load_x<RT>(xg + (size_t)r * RB + b0, xl);
            load_x<RT>(xg + (size_t)(r + half) * RB + b0, xh);
#pragma unroll
            for (int b = 0; b < RT; ++b)
#pragma unroll
                for (int j = 0; j < CPT; ++j) gacc[b][j] = fmaf(xh[b], hi[j], fmaf(xl[b], lo[j], gacc[b][j]));
        }
        const float4 sv = *reinterpret_cast<const float4*>(ss + st * TN + cgi * CPT);
        const float s[CPT] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int b = 0; b < RT; ++b)
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[b][j] = fmaf(gacc[b][j], s[j], acc[b][j]);
        if (st + slots < ngroups) {
            __syncthreads();  // the slot is read: refill it
            if (tid == 0) issue(st + slots);
        }
    }
    __syncthreads();  // every slot read: the ring becomes red

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

    // This rank's columns: the ranks' sums in rank order.
    const int c_lo = rank * per, ncols = max(0, min(TN, c_lo + per) - c_lo);
    for (int idx = tid; idx < B * ncols; idx += THREADS) {
        const int b = idx / ncols, c = idx - b * ncols, n = n0 + c_lo + c;
        if (n < N) {
            float s = 0.f;
            for (int r = 0; r < C; ++r) s += recv[((size_t)r * B + b) * per + c];
            y[(size_t)b * N + n] = s;
        }
    }
}

template <int RB>
int launch(const CUtensorMap& wmap, const void* x, const void* s4, void* y, int B, int K, int N, int half,
           int cluster, int gpr, int smem_bytes, cudaStream_t st)
{
    static bool configured = false;
    const int err = zt::configure_once(int4_gemv_cluster<RB>, configured);
    if (err) return err;
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
    const cudaError_t e = cudaLaunchKernelEx(&cfg, int4_gemv_cluster<RB>, wmap, static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const float*>(s4), static_cast<float*>(y), B, K, N, half,
                                             gpr, per, MAX_SLOTS);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// cluster K ranks of gpr whole groups each (cluster * gpr * group >= K),
// smem_bytes as ops/cuda_matmul.int4_matmul_plan lays it out.
extern "C" int zt_int4_matmul(const void* x, const void* q4, const void* s4, void* y, int B, int K, int N, int group,
                              int cluster, int gpr, int smem_bytes, void* stream)
{
    const int half = group / 2;
    if (B < 1 || B > 32 || group < 2 || group % 2 || half > 256 || K % group || cluster < 1 ||
        cluster > zt::MAX_CLUSTER || (long long)cluster * gpr * group < K || N % 16 ||
        (reinterpret_cast<uintptr_t>(q4) & 15) || (reinterpret_cast<uintptr_t>(s4) & 15))
        return (int)cudaErrorInvalidValue;
    CUtensorMap wmap = {};
    const int err = zt::weight_map(q4, N, K / 2, N, TN, half, &wmap);
    if (err) return err;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (B == 1) return launch<1>(wmap, x, s4, y, B, K, N, half, cluster, gpr, smem_bytes, st);
    if (B == 2) return launch<2>(wmap, x, s4, y, B, K, N, half, cluster, gpr, smem_bytes, st);
    if (B <= 4) return launch<4>(wmap, x, s4, y, B, K, N, half, cluster, gpr, smem_bytes, st);
    if (B <= 8) return launch<8>(wmap, x, s4, y, B, K, N, half, cluster, gpr, smem_bytes, st);
    if (B <= 16) return launch<16>(wmap, x, s4, y, B, K, N, half, cluster, gpr, smem_bytes, st);
    return launch<32>(wmap, x, s4, y, B, K, N, half, cluster, gpr, smem_bytes, st);
}
