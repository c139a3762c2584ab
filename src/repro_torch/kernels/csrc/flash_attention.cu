// Hand-written Hopper (sm_90a) flash attention for the served LMs: every
// attention layer over a fresh sequence (forward, prefill, both halves of a
// split) runs through it.
//
// Replaces src/repro/kernels/flash_attention.py flash_attention_kernel
// (_kernel): GQA softmax attention with causal / local-window /
// bidirectional masks and a kv_len mask, online softmax with a float32
// (m, l, acc) carry.
//
//   q   (BH, Sq, hd)           BH = B * KV * G, query head row bh
//   k/v (BH / G, Sk, hd)       the KV row of bh is bh / G
//   out (BH, Sq, hd)           same dtype as q (bf16 or float32)
//
// Arithmetic, as the TPU kernel: scores are float32 dot products of the
// inputs times hd^-0.5, masked to the finite -1e30 (never -inf, so a row
// whose first key block is all masked gives exp(0) terms that the first
// real block's correction exp(-1e30 - m) erases exactly); p = exp(s - m) is
// summed unrounded into l and rounded to the input dtype before the AV
// product; out = acc / max(l, 1e-30), cast to the input dtype. A query row
// with no unmasked key at all is undefined (the TPU kernel averages its
// padded keys there); the model never makes one.
//
// Bound: operations. At B=4, S=3072, H=16, KV=1, hd=256, window 2048,
// causal, the unmasked pairs need 2.75e11 FLOP (0.278 ms at 989 TFLOP/s
// bf16) against 214 MB of bytes (0.064 ms at 3.35 TB/s).
// Design: one thread block per (query head row, 64-query block); the loop
// over 64-key blocks runs inside the block (the TPU's sequential
// "arbitrary" grid axis and its pl.when init/finish become the loop's
// prologue and epilogue). Key blocks wholly outside the causal or window
// band are skipped, which changes no value: the TPU kernel's visits there
// add exact zeros. Q, K and V tiles are staged in dynamic shared memory
// (116 KB at hd=256 in bf16, 210 KB in float32, above the 48 KB default,
// so the entry point opts in); 256 threads as 16 x 16, each holding a 4 x 4
// register tile of scores and a 4 x hd/16 tile of the accumulator, with
// plain float32 FMAs (no tensor cores yet: this first version is simple
// and right; wgmma and TMA are later work). The Q and K rows are padded by
// one 32-bit word so lanes reading one column of consecutive rows hit
// different banks. Ragged Sq and Sk edges are masked in the kernel: rows
// past Sk load as zeros and are masked by kv_len <= Sk; rows past Sq are
// computed and not stored.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() (or the error of the
// shared-memory opt-in, made once per device at the first launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // 16 x 16
constexpr int kRows = 4;          // query rows per thread: kBlockQ / 16
constexpr int kCols = 4;          // key columns per thread: kBlockK / 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row stride (elements) of the Q and K tiles: one extra 32-bit word a row.
template <typename T, int HD>
__host__ __device__ constexpr int qk_stride() { return HD + static_cast<int>(4 / sizeof(T)); }
constexpr int kPStride = kBlockK + 1;   // float P tile

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(T) * (static_cast<size_t>(kBlockQ + kBlockK) * qk_stride<T, HD>() +
                      static_cast<size_t>(kBlockK) * HD) +
         sizeof(float) * (static_cast<size_t>(kBlockQ) * kPStride + 3 * kBlockQ);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Sk, int group, int causal, int window,
             int kv_len, float sm_scale) {
  constexpr int QS = qk_stride<T, HD>();
  constexpr int TC = HD / 16;           // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBlockQ * QS;
  T* Vs = Ks + kBlockK * QS;
  float* Ps = reinterpret_cast<float*>(Vs + kBlockK * HD);
  float* m_s = Ps + kBlockQ * kPStride;  // running max of each row
  float* l_s = m_s + kBlockQ;            // running sum of each row
  float* c_s = l_s + kBlockQ;            // this key block's correction

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const T* qp = q + static_cast<size_t>(bh) * Sq * HD;
  const T* kp = k + static_cast<size_t>(bh / group) * Sk * HD;
  const T* vp = v + static_cast<size_t>(bh / group) * Sk * HD;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T zero = from_f32<T>(0.f);

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    Qs[r * QS + c] = (q0 + r < Sq) ? qp[static_cast<size_t>(q0 + r) * HD + c] : zero;
  }
  if (tid < kBlockQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kRows][TC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;

  // Key blocks that can hold an unmasked key for some row of this block.
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBlockK) * kBlockK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous block is done with Ks, Vs, Ps
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const bool ok = k0 + r < Sk;
      const size_t g = static_cast<size_t>(k0 + r) * HD + c;
      Ks[r * QS + c] = ok ? kp[g] : zero;
      Vs[r * HD + c] = ok ? vp[g] : zero;
    }
    __syncthreads();

    // Scores of rows ty*4+i against keys tx+16j.
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = to_f32(Qs[(ty * kRows + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = to_f32(Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, then the online-softmax update of each row. A row's 16 threads
    // are one half-warp, so its reductions are shuffles within it; every
    // lane reads m_s[r] before the sum's shuffles, and only lane tx == 0
    // writes the row state after them.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int q_pos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        bool ok = k_pos < kv_len;
        if (causal) ok = ok && k_pos <= q_pos;
        if (window > 0) ok = ok && (q_pos - k_pos) < window;
        s[i][j] = ok ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[r * kPStride + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (tx == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V over this key block; columns tx + 16c.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float corr = c_s[ty * kRows + i];
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] *= corr;
    }
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float vv = to_f32(Vs[kk * HD + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

  T* op = out + static_cast<size_t>(bh) * Sq * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < TC; ++c)
      op[static_cast<size_t>(q0 + r) * HD + tx + 16 * c] = from_f32<T>(acc[i][c] / den);
  }
}

// Opt the kernel in to its dynamic shared memory once per device, so a
// launch inside CUDA-graph capture makes no attribute call.
constexpr int kMaxDevices = 64;

template <typename T, int HD>
cudaError_t opt_in_smem(int device) {
  static bool done[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T, HD>()));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) done[device] = true;
  return err;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Sk,
           int group, int causal, int window, int kv_len, float sm_scale, int device,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, HD>();
  const cudaError_t err = opt_in_smem<T, HD>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, ceil_div(Sq, kBlockQ));
  flash_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, group, causal, window, kv_len, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out, int BH,
                int Sq, int Sk, int group, int causal, int window, int kv_len,
                float sm_scale, int device, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, BH, Sq, Sk, group, causal, window, kv_len, sm_scale, device, s);
    case 64: return launch<T, 64>(q, k, v, out, BH, Sq, Sk, group, causal, window, kv_len, sm_scale, device, s);
    case 128: return launch<T, 128>(q, k, v, out, BH, Sq, Sk, group, causal, window, kv_len, sm_scale, device, s);
    case 256: return launch<T, 256>(q, k, v, out, BH, Sq, Sk, group, causal, window, kv_len, sm_scale, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// hd in {32, 64, 128, 256}; bf16 != 0 for bfloat16 tensors, else float32.
// window 0 means no window; 0 <= kv_len <= Sk.
int flash_attention(const void* q, const void* k, const void* v, void* out, int BH, int Sq,
                    int Sk, int hd, int group, int causal, int window, int kv_len, int bf16,
                    float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, BH, Sq, Sk, group, causal, window,
                                      kv_len, sm_scale, device, s);
  }
  return dispatch_hd<float>(hd, q, k, v, out, BH, Sq, Sk, group, causal, window, kv_len,
                            sm_scale, device, s);
}

}  // extern "C"
