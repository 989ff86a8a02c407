// K3: gated-SiLU MLP with int8 weights, for the decode step.
//
// Replaces the TPU kernels zonos_tpu/ops/pallas_matmul.py::fused_mlp_int8
// and ::fused_mlp_int8_split (body _fused_mlp_kernel):
//     out = ((x @ w1_y) * s1y * silu((x @ w1_g) * s1g)) @ w2 * s2
// with x bf16 [B, D], w1 int8 (y and gate halves), w2 int8 [F, Dout], the
// hidden h rounded to bf16 before fc2, and out f32 [B, Dout].
//
// Bound on an H100: device-memory bytes — the 3 * D * F int8 weights (50 MB
// per layer at D 2048, F 8192); x and h are a few KB. The TPU kernel kept h
// in VMEM by walking F chunks in order; on Hopper the blocks run in no order,
// so the MLP is four launches of the shared int8 GEMV body (gemv_int8.cuh):
//   1. fc1 partials for y and gate in ONE launch (grid.z picks the half):
//      the fused layout passes w1q and w1q + F with leading dimension 2F,
//      the split layout two separate [D, F] arrays with leading dimension F;
//   2. silu_gate: sum the K chunks, apply s1y / s1g, h = bf16(y * silu(g));
//   3. fc2 partials over h (split-F across blocks);
//   4. the fixed-order reduce that applies s2.
// h is B * F bf16 (32 KB at B 2) and stays in L2 between launches.

#include "gemv_int8.cuh"

namespace {

__global__ void silu_gate(const float* __restrict__ part1, const float* __restrict__ s1y,
                          const float* __restrict__ s1g, __nv_bfloat16* __restrict__ h,
                          int splits, int B, int F)
{
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= B * F) return;
    const size_t half = (size_t)splits * B * F;  // partial[1] (gate) follows partial[0] (y)
    float y = 0.f, g = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
        y += part1[(size_t)sp * B * F + idx];
        g += part1[half + (size_t)sp * B * F + idx];
    }
    const int f = idx % F;
    y *= s1y[f];
    g *= s1g[f];
    h[idx] = __float2bfloat16(y * (g * (1.f / (1.f + expf(-g)))));
}

}  // namespace

extern "C" int zt_fused_mlp_int8(const void* x, const void* w1y, const void* w1g, int ld1,
                                 const void* s1y, const void* s1g, const void* w2, const void* s2,
                                 void* part1, void* h, void* part2, void* y,
                                 int B, int D, int F, int Dout,
                                 int kchunk1, int splits1, int kchunk2, int splits2, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    zt::launch_partial(static_cast<const __nv_bfloat16*>(x), D, static_cast<const int8_t*>(w1y),
                       static_cast<const int8_t*>(w1g), 2, ld1, static_cast<float*>(part1),
                       B, D, F, kchunk1, splits1, st);
    const int total = B * F;
    silu_gate<<<(total + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(part1), static_cast<const float*>(s1y),
        static_cast<const float*>(s1g), static_cast<__nv_bfloat16*>(h), splits1, B, F);
    zt::launch_partial(static_cast<const __nv_bfloat16*>(h), F, static_cast<const int8_t*>(w2),
                       nullptr, 1, Dout, static_cast<float*>(part2), B, F, Dout, kchunk2, splits2, st);
    zt::launch_reduce(static_cast<const float*>(part2), static_cast<const float*>(s2),
                      static_cast<float*>(y), splits2, B, Dout, st);
    return (int)cudaGetLastError();
}
