// Hand-written Hopper (sm_90a) kernel for the RG-LRU linear recurrence of
// RecurrentGemma: every recurrent layer over a sequence (forward, prefill,
// both halves of a split) runs through it.
//
// Replaces src/repro/kernels/rg_lru.py rg_lru_kernel (_kernel):
//
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = h0 (zeros when absent)
//
//   log_a, b, out (B, S, W) float32 row-major; h0 (B, W) float32 or null.
//
// Bound: bytes. log_a and b are read and h written once: 604 MB at
// (4, 3072, 4096), 0.180 ms at 3.35 TB/s; the arithmetic is one exp and one
// multiply-add per element.
// Design: one thread per (b, w) channel; h lives in a register across the
// loop over S, which takes the place of the TPU kernel's sequential S-block
// grid axis and its VMEM carry. Consecutive threads take consecutive w, so
// every load and store coalesces. The loads of log_a and b and their exp do
// not depend on h: the loop is unrolled by kUnroll so they are all issued
// ahead of the serial multiply-add chain. The multiply and the add are
// rounded separately (__fmul_rn, __fadd_rn: no contraction into an FMA) and
// expf is the accurate one (no fast math), so the kernel rounds as its plain
// PyTorch twin does. At B=4, W=4096 only 16,384 threads exist for 132 SMs:
// too few loads in flight to reach the bytes bound; splitting S into
// chunks with a second pass over the chunk carries is later work.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
              const float* __restrict__ h0, float* __restrict__ out, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t row = static_cast<size_t>(blockIdx.y);
  const size_t base = row * S * W + w;
  float h = h0 != nullptr ? h0[row * W + w] : 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + static_cast<size_t>(t + u) * W;
      a[u] = log_a[i];
      x[u] = b[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = expf(a[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(a[u], h), x[u]);
      out[base + static_cast<size_t>(t + u) * W] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t i = base + static_cast<size_t>(t) * W;
    h = __fadd_rn(__fmul_rn(expf(log_a[i]), h), b[i]);
    out[i] = h;
  }
}

}  // namespace

extern "C" {

// h0 may be null (zeros). Grid: (ceil(W / kThreads), B).
int rg_lru(const float* log_a, const float* b, const float* h0, float* out, int B, int S,
           int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rg_lru_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(log_a, b, h0, out,
                                                                          S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
