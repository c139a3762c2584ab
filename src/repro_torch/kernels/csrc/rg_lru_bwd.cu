// Hand-written Hopper (sm_90a) kernel for the gradient of the RG-LRU linear
// recurrence: every recurrent layer of a training step's backward runs
// through it (the forward is csrc/rg_lru.cu).
//
// Replaces the gradient the JAX package takes through its associative scan
// (src/repro/models/recurrent.py _rglru_scan, jax.grad; no pallas_call).
// For the forward h_t = a_t * h_{t-1} + b_t with a_t = exp(log_a_t) and
// h_{-1} = h0 (zeros when absent), and the output gradient g = dL/dh:
//
//   lam_{S-1} = g_{S-1},  lam_t = a_{t+1} * lam_{t+1} + g_t
//   db_t = lam_t,  dlog_a_t = (lam_t * a_t) * h_{t-1},  dh0 = a_0 * lam_0
//
//   log_a, h (the forward's output), g, dlog_a, db (B, S, W) float32
//   row-major; h0, dh0 (B, W) float32 or null.
//
// Bound: bytes. log_a, h and g are read and dlog_a and db written once, 20
// bytes an element: 503 MB at (2, 3072, 4096), 0.150 ms at 3.35 TB/s; the
// arithmetic is one exp, one multiply-add and two multiplies an element.
//
// Design: the forward's, run backwards in time. One thread per (b, w)
// channel holds lam and a_{t+1} in registers and walks t from S - 1 down to
// 0; the multiplies and the add are rounded separately (__fmul_rn /
// __fadd_rn, no contraction into an FMA), dlog_a's two products in a fixed
// order, expf the accurate one, no atomics: the kernel is bit-equal to its
// plain PyTorch twin (kernels/rg_lru.py rg_lru_bwd_plain). The operands
// reach the thread through a ring of kStages time tiles in shared memory,
// filled ahead from the end of the sequence: each tile is kSteps steps x
// kChannels channels of log_a and g at steps [t0, t0 + kSteps) and of h one
// step earlier, [t0 - 1, t0 + kSteps - 1), so step t finds h_{t-1} in the
// same tile. A block is one warp of kChannels channels. Two ways to fill a
// tile, one kernel:
// - TMA (W % 4 == 0 and 16-byte-aligned log_a, h and g): lane 0 issues one
//   3-D box load of each operand against the stage's mbarrier, armed with
//   the three boxes' bytes (the hardware counts a box's full size: elements
//   past S or W, and h's step -1, load as zeros and are counted too).
// - cp.async (any W or alignment): each thread copies its own channel's
//   values, 4 bytes each, one commit group a tile.
// Step 0 reads h_{-1} from h0 (or 0), never from the ring. A stage is
// refilled once every thread has read it (a barrier after the tile).
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
constexpr int kStages = 3;     // tiles in the ring (3 x 3 x 4 KB of static shared memory)
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
rg_lru_bwd_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_h,
                  const __grid_constant__ CUtensorMap tm_g, const float* __restrict__ log_a,
                  const float* __restrict__ h, const float* __restrict__ g,
                  const float* __restrict__ h0, float* __restrict__ dlog_a,
                  float* __restrict__ db, float* __restrict__ dh0, int S, int W) {
  __shared__ __align__(128) float ring_a[kStages][kSteps][kChannels];
  __shared__ __align__(128) float ring_h[kStages][kSteps][kChannels];  // one step earlier
  __shared__ __align__(128) float ring_g[kStages][kSteps][kChannels];
  __shared__ __align__(8) uint64_t full[kStages];

  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kChannels;
  const int w = w0 + lane;
  const bool w_ok = w < W;
  const int row = blockIdx.y;
  const size_t base = static_cast<size_t>(row) * S * W + w;
  const int n_tiles = (S + kSteps - 1) / kSteps;

  // Start filling the k-th tile from the end (time tile n_tiles - 1 - k)
  // into its stage; a no-op for k >= n_tiles, except that the cp.async
  // path still commits its, empty, group.
  auto fill = [&](int k) {
    const int st = k % kStages;
    const int t0 = (n_tiles - 1 - k) * kSteps;
    if constexpr (TMA) {
      if (lane == 0 && k < n_tiles) {
        const uint32_t bar = smem_u32(&full[st]);
        mbar_expect_tx(bar, 3 * kTileBytes);
        tma_load_3d(smem_u32(&ring_a[st][0][0]), &tm_a, bar, w0, t0, row);
        tma_load_3d(smem_u32(&ring_h[st][0][0]), &tm_h, bar, w0, t0 - 1, row);
        tma_load_3d(smem_u32(&ring_g[st][0][0]), &tm_g, bar, w0, t0, row);
      }
    } else {
      if (w_ok && k < n_tiles) {
        const int steps = min(kSteps, S - t0);
        for (int t = 0; t < steps; ++t) {
          const size_t i = base + static_cast<size_t>(t0 + t) * W;
          cp_async_f32(&ring_a[st][t][lane], log_a + i);
          cp_async_f32(&ring_g[st][t][lane], g + i);
          if (t0 + t > 0) cp_async_f32(&ring_h[st][t][lane], h + i - W);
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

  const float h_init = (h0 != nullptr && w_ok) ? h0[static_cast<size_t>(row) * W + w] : 0.f;
  float lam = 0.f;
  float a_next = 0.f;  // a_{t+1}; 0 past the end, so lam_{S-1} = 0 * 0 + g_{S-1}
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % kStages;
    if constexpr (TMA) {
      mbar_wait(smem_u32(&full[st]), (k / kStages) & 1);
    } else {
      cp_async_wait<kStages - 1>();  // this thread's copies of tile k are done
    }
    const int t0 = (n_tiles - 1 - k) * kSteps;
    const int steps = min(kSteps, S - t0);
    float* da = dlog_a + base + static_cast<size_t>(t0) * W;
    float* dbt = db + base + static_cast<size_t>(t0) * W;
    if (steps == kSteps && t0 > 0) {
      // A whole tile past step 0: the exps do not depend on lam, so they are
      // all issued ahead of the serial chain.
      float a[kSteps];
#pragma unroll
      for (int t = 0; t < kSteps; ++t) a[t] = expf(ring_a[st][t][lane]);
#pragma unroll
      for (int t = kSteps - 1; t >= 0; --t) {
        lam = __fadd_rn(__fmul_rn(a_next, lam), ring_g[st][t][lane]);
        const float d = __fmul_rn(__fmul_rn(lam, a[t]), ring_h[st][t][lane]);
        if (w_ok) {
          dbt[static_cast<size_t>(t) * W] = lam;
          da[static_cast<size_t>(t) * W] = d;
        }
        a_next = a[t];
      }
    } else {
      for (int t = steps - 1; t >= 0; --t) {
        const float at = expf(ring_a[st][t][lane]);
        lam = __fadd_rn(__fmul_rn(a_next, lam), ring_g[st][t][lane]);
        const float hp = (t0 + t == 0) ? h_init : ring_h[st][t][lane];
        const float d = __fmul_rn(__fmul_rn(lam, at), hp);
        if (w_ok) {
          dbt[static_cast<size_t>(t) * W] = lam;
          da[static_cast<size_t>(t) * W] = d;
        }
        a_next = at;
      }
    }
    __syncthreads();  // every thread has read stage st: it may be refilled
    fill(k + kStages);
  }
  if (dh0 != nullptr && w_ok) dh0[static_cast<size_t>(row) * W + w] = __fmul_rn(a_next, lam);
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
// kChannels x kSteps x 1; elements past W or S, or before step 0, load as
// zeros.
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

// h0 and dh0 may be null (h0 zeros; dh0 not written); both or neither.
// tma != 0 fills the ring by TMA and needs W % 4 == 0 and log_a, h, g on
// 16-byte boundaries (the caller decides: kernels/rg_lru.py uses_tma;
// cuTensorMapEncodeTiled refuses any other tensor map, and the launch then
// fails with kErrEncode); tma == 0 fills it by cp.async. Grid
// (ceil(W / kChannels), B) of kChannels threads, 36,888 bytes of static
// shared memory.
int rg_lru_bwd(const float* log_a, const float* h, const float* g, const float* h0,
               float* dlog_a, float* db, float* dh0, int B, int S, int W, int tma, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || S < 1 || W < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kChannels - 1) / kChannels, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_a = {}, tm_h = {}, tm_g = {};
  if (tma) {
    int rc = make_map(&tm_a, log_a, B, S, W);
    if (rc == 0) rc = make_map(&tm_h, h, B, S, W);
    if (rc == 0) rc = make_map(&tm_g, g, B, S, W);
    if (rc != 0) return rc;
    rg_lru_bwd_kernel<true><<<grid, kChannels, 0, s>>>(tm_a, tm_h, tm_g, log_a, h, g, h0,
                                                       dlog_a, db, dh0, S, W);
  } else {
    rg_lru_bwd_kernel<false><<<grid, kChannels, 0, s>>>(tm_a, tm_h, tm_g, log_a, h, g, h0,
                                                        dlog_a, db, dh0, S, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
