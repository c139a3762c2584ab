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
// multiply-add per element. Covering HBM's latency at that rate takes about
// 2 MB of loads in flight across the card, and the recurrence has only
// B * W = 16,384 independent channels: loads issued by the thread that
// consumes them, even 8 steps ahead, keep only about 1 MB in flight.
//
// Design: the arithmetic is one thread per (b, w) channel with h in a
// register, the serial __fadd_rn(__fmul_rn(expf(log_a), h), b) over S in
// order: the multiply and the add are rounded separately (no contraction
// into an FMA) and expf is the accurate one (no fast math), so the kernel is
// bit-equal to its plain PyTorch twin. Only the way the operands reach the
// thread is asynchronous: a block is one warp of kChannels channels with a
// ring of kStages time tiles in shared memory, each tile kSteps steps x
// kChannels channels of log_a and of b (8 KB), filled kStages tiles ahead of
// the step being computed. At (4, 3072, 4096) that is 512 blocks, about 4 on
// each SM, with up to 4 x 4 x 8 KB in flight per SM. Outputs are stored
// straight from the registers (a warp writes 128 contiguous bytes a step).
// Two ways to fill a tile, one kernel:
// - TMA (W % 4 == 0 and 16-byte-aligned log_a and b): lane 0 issues one
//   3-D box load (kChannels x kSteps x 1 over the (W, S, B) tensor) of each
//   operand against the stage's mbarrier, armed with both boxes' bytes.
//   The hardware counts a box's full size, zero-filled elements past S or W
//   included, so a ragged last tile is armed with the same byte count.
// - cp.async (any W): each thread copies its own channel's kSteps values of
//   log_a and b, 4 bytes each, one commit group a tile (empty groups past
//   the last tile keep the count); a ragged tile copies only its steps.
// A stage is refilled once every thread has read it (a barrier after the
// tile); the phase of a stage's mbarrier flips on every lap of the ring.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() (or a negative code when
// no tensor map could be made).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChannels = 32;  // channels a block: one warp, one thread each
constexpr int kSteps = 32;     // time steps a tile
constexpr int kStages = 4;     // tiles in the ring
constexpr uint32_t kTileBytes = kSteps * kChannels * sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Block until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Grid (ceil(W / kChannels), B) of kChannels threads.
template <bool TMA>
__global__ void __launch_bounds__(kChannels)
rg_lru_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
              const float* __restrict__ log_a, const float* __restrict__ b,
              const float* __restrict__ h0, float* __restrict__ out, int S, int W) {
  __shared__ __align__(128) float ring_a[kStages][kSteps][kChannels];
  __shared__ __align__(128) float ring_b[kStages][kSteps][kChannels];
  __shared__ __align__(8) uint64_t full[kStages];

  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kChannels;
  const int w = w0 + lane;
  const bool w_ok = w < W;
  const int row = blockIdx.y;
  const size_t base = static_cast<size_t>(row) * S * W + w;
  const int n_tiles = (S + kSteps - 1) / kSteps;

  // Start filling tile `tile` into its stage (a no-op past the last tile,
  // except that the cp.async path still commits its, empty, group).
  auto fill = [&](int tile) {
    const int st = tile % kStages;
    const int t0 = tile * kSteps;
    if constexpr (TMA) {
      if (lane == 0 && tile < n_tiles) {
        const uint32_t bar = smem_u32(&full[st]);
        mbar_expect_tx(bar, 2 * kTileBytes);
        tma_load_3d(smem_u32(&ring_a[st][0][0]), &tm_a, bar, w0, t0, row);
        tma_load_3d(smem_u32(&ring_b[st][0][0]), &tm_b, bar, w0, t0, row);
      }
    } else {
      if (w_ok && tile < n_tiles) {
        const int steps = min(kSteps, S - t0);
        for (int t = 0; t < steps; ++t) {
          const size_t i = base + static_cast<size_t>(t0 + t) * W;
          cp_async_f32(&ring_a[st][t][lane], log_a + i);
          cp_async_f32(&ring_b[st][t][lane], b + i);
        }
      }
      cp_async_commit();
    }
  };

  if constexpr (TMA) {
    if (lane == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(smem_u32(&full[st]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int k = 0; k < kStages; ++k) fill(k);

  float h = (h0 != nullptr && w_ok) ? h0[static_cast<size_t>(row) * W + w] : 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    if constexpr (TMA) {
      mbar_wait(smem_u32(&full[st]), (i / kStages) & 1);
    } else {
      cp_async_wait<kStages - 1>();  // this thread's copies of tile i are done
    }
    const int t0 = i * kSteps;
    float* o = out + base + static_cast<size_t>(t0) * W;
    if (t0 + kSteps <= S) {
      // A whole tile: the exps do not depend on h, so they are all issued
      // ahead of the serial multiply-add chain.
      float a[kSteps];
#pragma unroll
      for (int t = 0; t < kSteps; ++t) a[t] = expf(ring_a[st][t][lane]);
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        h = __fadd_rn(__fmul_rn(a[t], h), ring_b[st][t][lane]);
        if (w_ok) o[static_cast<size_t>(t) * W] = h;
      }
    } else {
      for (int t = 0; t < S - t0; ++t) {
        h = __fadd_rn(__fmul_rn(expf(ring_a[st][t][lane]), h), ring_b[st][t][lane]);
        if (w_ok) o[static_cast<size_t>(t) * W] = h;
      }
    }
    __syncthreads();  // every thread has read stage st: it may be refilled
    fill(i + kStages);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kErrNoEncode = -1;  // no cuTensorMapEncodeTiled was found
constexpr int kErrEncode = -2;    // cuTensorMapEncodeTiled refused a tensor map

// A (B, S, W) float32 tensor as a 3-D tensor map (W innermost) whose box is
// kChannels x kSteps x 1; elements past W or S load as zeros.
int make_map(CUtensorMap* map, const float* ptr, int B, int S, int W) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoEncode;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * sizeof(float),
                                 static_cast<cuuint64_t>(W) * S * sizeof(float)};
  const cuuint32_t box[3] = {kChannels, kSteps, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                         const_cast<float*>(ptr), dims, strides, box, elem_strides,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

}  // namespace

extern "C" {

// h0 may be null (zeros). tma != 0 fills the ring by TMA and needs
// W % 4 == 0 and log_a, b on 16-byte boundaries (the caller decides:
// kernels/rg_lru.py uses_tma; cuTensorMapEncodeTiled refuses any other
// tensor map, and the launch then fails with kErrEncode); tma == 0 fills
// it by cp.async. Grid (ceil(W / kChannels), B) of kChannels threads,
// 32,800 bytes of static shared memory.
int rg_lru(const float* log_a, const float* b, const float* h0, float* out, int B, int S,
           int W, int tma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || S < 1 || W < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kChannels - 1) / kChannels, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_a = {}, tm_b = {};
  if (tma) {
    int rc = make_map(&tm_a, log_a, B, S, W);
    if (rc == 0) rc = make_map(&tm_b, b, B, S, W);
    if (rc != 0) return rc;
    rg_lru_kernel<true><<<grid, kChannels, 0, s>>>(tm_a, tm_b, log_a, b, h0, out, S, W);
  } else {
    rg_lru_kernel<false><<<grid, kChannels, 0, s>>>(tm_a, tm_b, log_a, b, h0, out, S, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
