// K3: gated-SiLU MLP with int8 weights, for the decode step.
//
// Replaces the TPU kernels zonos_tpu/ops/pallas_matmul.py::fused_mlp_int8
// and ::fused_mlp_int8_split (body _fused_mlp_kernel):
//     out = ((x @ w1_y) * s1y * silu((x @ w1_g) * s1g)) @ w2 * s2
// with x bf16 [B, D], 1 <= B <= 32, w1 int8 (y and gate halves), w2 int8
// [F, Dout], the hidden h rounded to bf16 before fc2, and out f32 [B, Dout].
//
// Bound on an H100: device-memory bytes, the 3 * D * F int8 weights (50.4 MB
// per layer at D 2048, F 8192, with the scales); x and h are KBs. The TPU
// kernel walks F chunks in order and keeps h in VMEM. Here the MLP is TWO
// launches, the second a programmatic dependent of the first
// (ops/cuda_matmul.fused_mlp_plan):
//   1. mlp_fc1_gate: a cluster of 2 blocks owns the F columns [128 i,
//      128 i + 128) of both halves, each rank half of the D rows. One thread
//      per rank streams its w1 rows into a ring, each slot two 2-D TMA boxes
//      ([64, 128] of y and [64, 128] of gate) from two tensor maps; the other
//      warps stage the rank's x rows once (bf16, k-major, every B row padded
//      to 1, 2, 4, 8, 16 or 32). A thread takes 4 columns of y or of gate (a
//      warp reads one 128-byte box row) and every 8th row of a slot,
//      dequantized by byte permutes (exact) and summed in f32 for at most
//      16 rows of x (at B 32 the threads form two halves of 4 row groups,
//      one per 16 rows, as K1's body does). The row groups are added in
//      shared memory; each rank pushes the sums of the 64
//      F columns the other rank finishes into its shared memory (distributed
//      shared memory stores), and after a cluster barrier each rank adds the
//      two ranks' sums in rank order, scales them, and writes
//      h = bf16(y * silu(g)) to a scratch [B, F] bf16 buffer that the wrapper
//      keeps per device (32 KB at B 2): h is the only thing written between
//      the launches, no partial sum is.
//   2. fc2 is K1's body (gemv_cluster.cuh) over h: split-F in a cluster,
//      reduced over distributed shared memory in rank order, s2 applied once.
//      Launch 1 lets it start at once (griddepcontrol.launch_dependents); at
//      B <= 4 both kernels are sized to share an SM (at most 64 registers a
//      thread, the plan's rings), so fc2's blocks issue their w2 copies, which
//      do not depend on h, while fc1 still streams w1, then wait
//      (griddepcontrol.wait) for launch 1's h.
// Both sums are in a fixed order: deterministic, no atomics. The split
// layout (K3s) is the same code, with the gate's own pointer and row stride.
//
// Why two launches and not one (block-level h, fc2 partials summed across
// clusters): at B 16 one block would need x (64 KB as bf16), its fc1 sums
// (128 KB) and its fc2 partial [16, 2048] f32 (128 KB) beside the weight
// ring, over the 227 KB a block has; two launches keep each within it and
// let fc2 reuse K1's tested body. Tried in probes while designing it, and
// slower: 64-column fc1 blocks over all D rows (64-byte boxes stream worse
// than 128-byte ones), fc1 and fc2 each alone on its SMs, and PR 1's four
// launches of a two-pass GEMV (fc1 partials, a silu pass, fc2 partials, a
// reduce). What holds it back now: the same probes found that a kernel which
// only streams a weight of this size by TMA or bulk copies stays well below
// the card's 3.35 TB/s, so the two launches' weight stream alone takes most
// of K3's time.

#include "gemv_cluster.cuh"

namespace {

constexpr int FC = 128;              // F columns per cluster, in each half
constexpr int RANKS = 2;             // a cluster's ranks split D
constexpr int OWN = FC / RANKS;      // F columns each rank finishes: 64
constexpr int CPT = 4;               // columns per thread
constexpr int THREADS = 512;
constexpr int CG = 2 * FC / CPT;     // column groups: 64 (32 of y, 32 of gate)
constexpr int S1 = 64;               // rows per ring slot: one box [S1, FC] per half
constexpr int HALF_BYTES = S1 * FC;  // 8 KB
constexpr int SLOT_BYTES = 2 * HALF_BYTES;

template <int RB>
__device__ __forceinline__ void load_xh(const __nv_bfloat16* p, float* xv)
{
    if constexpr (RB == 1) {
        xv[0] = __bfloat162float(p[0]);
    } else {
#pragma unroll
        for (int i = 0; i < RB; i += 2) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
            xv[i] = f.x;
            xv[i + 1] = f.y;
        }
    }
}

// grid: (2, ceil(F / 128)), clusters of 2 along x. h: [B, F] bf16.
template <int RB>
__global__ void __launch_bounds__(THREADS, RB <= 4 ? 2 : 1)
mlp_fc1_gate(const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap gmap,
             const __nv_bfloat16* __restrict__ x, const float* __restrict__ s1y, const float* __restrict__ s1g,
             __nv_bfloat16* __restrict__ h, int B, int D, int F, int max_slots)
{
    using namespace zt;
    // A thread sums RT = min(RB, 16) rows of x; at RB 32 two thread halves of 4 row groups, else 8.
    constexpr int RT = RB < 16 ? RB : 16, KG = THREADS / (CG * (RB / RT));
    // fc2 may be launched now: it waits for this grid's end before reading h.
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    // The other rank writes into recv below: arrive now, wait before the first such write.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    extern __shared__ __align__(128) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, cgi = tid % CG, kgi = (tid / CG) % KG, b0 = tid / (CG * KG) * RT;
    const int f0 = blockIdx.y * FC;
    const int dh = (D + RANKS - 1) / RANKS;
    const int k_begin = min(D, rank * dh), rows = min(D, k_begin + dh) - k_begin;
    const int nstages = (rows + S1 - 1) / S1;
    const int slots = max(1, min(max_slots, nstages));

    // [mbarriers][ring [slots][y box, gate box], later red [KG][RB][2 FC] f32]
    // [xs [dh][RB] bf16][recv [RANKS][RB][2 OWN] f32]
    unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
    const size_t ring_bytes = max((size_t)slots * SLOT_BYTES, (size_t)KG * RB * 2 * FC * sizeof(float));
    int8_t* ring = reinterpret_cast<int8_t*>(smem + BAR_BYTES);
    float* red = reinterpret_cast<float*>(ring);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + BAR_BYTES + ring_bytes);
    float* recv = reinterpret_cast<float*>(smem + BAR_BYTES + ring_bytes + ((size_t)dh * RB * 2 + 15) / 16 * 16);

    auto issue = [&](int st) {
        const uint32_t bar = smem_u32(&bars[st % slots]);
        int8_t* dst = ring + (size_t)(st % slots) * SLOT_BYTES;
        mbar_expect(bar, (uint32_t)SLOT_BYTES);
        tma_box(dst, &ymap, f0, k_begin + st * S1, bar);
        tma_box(dst + HALF_BYTES, &gmap, f0, k_begin + st * S1, bar);
    };
    if (tid == 0) {
        for (int i = 0; i < slots; ++i) mbar_init(smem_u32(&bars[i]));
        mbar_fence_init();
        for (int st = 0; st < min(slots, nstages); ++st) issue(st);
    }
    for (int idx = tid - 32; idx < RB * rows; idx += THREADS - 32) {
        if (idx < 0) break;
        const int b = idx / rows, k = idx - b * rows;
        xs[k * RB + b] = b < B ? x[(size_t)b * D + k_begin + k] : __float2bfloat16(0.f);
    }
    __syncthreads();  // xs written, barriers initialised

    // Column groups 0-31 are y's columns, 32-63 gate's: a warp reads one box row.
    const int col_off = (cgi >= CG / 2 ? HALF_BYTES : 0) + (cgi % (CG / 2)) * CPT;
    float acc[RT][CPT];
#pragma unroll
    for (int b = 0; b < RT; ++b)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[b][j] = 0.f;

    for (int st = 0; st < nstages; ++st) {
        mbar_wait(smem_u32(&bars[st % slots]), (uint32_t)(st / slots) & 1u);
        const int8_t* src = ring + (size_t)(st % slots) * SLOT_BYTES + col_off;
        const int r0 = st * S1, nr = min(S1, rows - r0);
#pragma unroll
        for (int i = 0; i < S1 / KG; ++i) {
            const int r = kgi + i * KG;
            if (r < nr) {
                float wf[CPT], xv[RT];
                unpack4(*reinterpret_cast<const uint32_t*>(src + r * FC), wf);
                load_xh<RT>(xs + (size_t)(r0 + r) * RB + b0, xv);
#pragma unroll
                for (int b = 0; b < RT; ++b)
#pragma unroll
                    for (int j = 0; j < CPT; ++j) acc[b][j] = fmaf(xv[b], wf[j], acc[b][j]);
            }
        }
        if (st + slots < nstages) {
            __syncthreads();  // the slot is read: refill it
            if (tid == 0) issue(st + slots);
        }
    }
    __syncthreads();  // every slot read: the ring becomes red

    // red column c < 128 is y's column f0 + c, c >= 128 gate's column f0 + c - 128.
#pragma unroll
    for (int b = 0; b < RT; ++b)
        *reinterpret_cast<float4*>(red + ((size_t)kgi * RB + b0 + b) * 2 * FC + cgi * CPT) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // both ranks have started
    // The block's row groups; the sums of F column c go to the rank that owns c.
    for (int idx = tid; idx < B * 2 * FC; idx += THREADS) {
        const int b = idx / (2 * FC), c = idx - b * 2 * FC, half = c / FC, fc = c - half * FC;
        const int owner = fc / OWN;
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < KG; ++g) s += red[((size_t)g * RB + b) * 2 * FC + c];
        cluster.map_shared_rank(recv, owner)[((size_t)rank * RB + b) * 2 * OWN + half * OWN + fc - owner * OWN] = s;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

    // This rank's F columns: the ranks' sums in rank order, the scales, the gate.
    for (int idx = tid; idx < B * OWN; idx += THREADS) {
        const int b = idx / OWN, c = idx - b * OWN, f = f0 + rank * OWN + c;
        if (f < F) {
            float yv = 0.f, gv = 0.f;
#pragma unroll
            for (int r = 0; r < RANKS; ++r) {
                yv += recv[((size_t)r * RB + b) * 2 * OWN + c];
                gv += recv[((size_t)r * RB + b) * 2 * OWN + OWN + c];
            }
            yv *= s1y[f];
            gv *= s1g[f];
            h[(size_t)b * F + f] = __float2bfloat16(yv * (gv * (1.f / (1.f + expf(-gv)))));
        }
    }
}

template <int RB>
int launch_fc1(const CUtensorMap& ymap, const CUtensorMap& gmap, const void* x, const void* s1y, const void* s1g,
               void* h, int B, int D, int F, int slots, int smem_bytes, cudaStream_t st)
{
    static bool configured = false;
    const int err = zt::configure_once(mlp_fc1_gate<RB>, configured);
    if (err) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(RANKS, (F + FC - 1) / FC, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = RANKS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, mlp_fc1_gate<RB>, ymap, gmap, static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const float*>(s1y), static_cast<const float*>(s1g),
                                             static_cast<__nv_bfloat16*>(h), B, D, F, slots);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace
// w1y / w1g: the y and gate halves, [D, F] each with row stride ld1 (the
// fused layout passes w1 and w1 + F with ld1 = 2F). h: [B, F] bf16 scratch.
// fc1_slots / fc1_smem and cluster2 / kc2 / slots2 / smem2 as
// ops/cuda_matmul.fused_mlp_plan lays them out.
extern "C" int zt_fused_mlp_int8(const void* x, const void* w1y, const void* w1g, long long ld1, const void* s1y,
                                 const void* s1g, const void* w2, const void* s2, void* h, void* y, int B, int D,
                                 int F, int Dout, int fc1_slots, int fc1_smem, int cluster2, int kc2, int slots2,
                                 int smem2, void* stream)
{
    if (B < 1 || B > 32 || ld1 % 16 || ld1 < F || (reinterpret_cast<uintptr_t>(w1y) & 15) ||
        (reinterpret_cast<uintptr_t>(w1g) & 15))
        return (int)cudaErrorInvalidValue;
    CUtensorMap ymap = {}, gmap = {};
    int err = zt::weight_map(w1y, ld1, D, F, FC, S1, &ymap);
    if (!err) err = zt::weight_map(w1g, ld1, D, F, FC, S1, &gmap);
    if (err) return err;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (B == 1) err = launch_fc1<1>(ymap, gmap, x, s1y, s1g, h, B, D, F, fc1_slots, fc1_smem, st);
    else if (B == 2) err = launch_fc1<2>(ymap, gmap, x, s1y, s1g, h, B, D, F, fc1_slots, fc1_smem, st);
    else if (B <= 4) err = launch_fc1<4>(ymap, gmap, x, s1y, s1g, h, B, D, F, fc1_slots, fc1_smem, st);
    else if (B <= 8) err = launch_fc1<8>(ymap, gmap, x, s1y, s1g, h, B, D, F, fc1_slots, fc1_smem, st);
    else if (B <= 16) err = launch_fc1<16>(ymap, gmap, x, s1y, s1g, h, B, D, F, fc1_slots, fc1_smem, st);
    else err = launch_fc1<32>(ymap, gmap, x, s1y, s1g, h, B, D, F, fc1_slots, fc1_smem, st);
    if (err) return err;
    return zt::launch_gemv<true>(h, w2, Dout, s2, y, B, F, Dout, cluster2, kc2, slots2, smem2, st);
}
