// K1: int8 weight-only GEMV for the decode projections.
//
// Replaces the TPU kernel zonos_tpu/ops/pallas_matmul.py::int8_matmul
// (body _kernel): y[b, n] = sum_k x[b, k] * wq[k, n] * s[n], x bf16 [B, K]
// with 1 <= B <= 16, wq int8 [K, N], s f32 [N], y f32 [B, N].
//
// Bound on an H100: device-memory bytes (the int8 weight, read once). The
// design — 16-byte column loads, dequantize in registers, split-K across
// blocks with a fixed-order second pass that applies the scale — is in
// gemv_int8.cuh, shared with K3.

#include "gemv_int8.cuh"

extern "C" int zt_int8_matmul(const void* x, const void* wq, const void* scale, void* partial,
                              void* y, int B, int K, int N, int kchunk, int splits, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    zt::launch_partial(static_cast<const __nv_bfloat16*>(x), K, static_cast<const int8_t*>(wq),
                       nullptr, 1, N, static_cast<float*>(partial), B, K, N, kchunk, splits, st);
    zt::launch_reduce(static_cast<const float*>(partial), static_cast<const float*>(scale),
                      static_cast<float*>(y), splits, B, N, st);
    return (int)cudaGetLastError();
}
