// Hand-written Hopper (sm_90a) backward of the flash attention forward in
// flash_attention.cu: the gradients dQ, dK, dV of the causal / local-window /
// bidirectional, GQA, kv_len-masked softmax attention that every training
// step's attention layer runs.
//
// Replaces no TPU kernel: the JAX package differentiates attention with
// jax.grad through its jnp online-softmax core (src/repro/models/attention.py
// _chunked_mha), never through Pallas. The port's forward is a CUDA kernel,
// so its gradient is one too.
//
//   q, dq    (BH, Sq, hd)       BH = B * KV * G, query head row bh
//   k/v, dk/dv (BH / G, Sk, hd) the KV row of bh is bh / G
//   out, dout (BH, Sq, hd)      the forward's output and its cotangent
//   lse      (BH, Sq) float32   the forward's log-sum-exp (m + log l)
//   dvec     (BH, Sq) float32   scratch: D_i = sum_d dout_i * out_i
// All of q, k, v, out, dout, dq, dk, dv are bf16, or all float32.
//
// The usual two-pass FlashAttention-2 backward, in three launches:
//   1. flash_bwd_dot_kernel: D_i, one warp a row.
//   2. flash_bwd_dkdv_kernel: one block per (KV row, key block, column
//      slice). It loops over the group's G query head rows and every query
//      block that can see its keys, recomputes P^T = exp(S^T * scale - LSE)
//      under the forward's mask (-> 0 where masked), and accumulates
//      dV += P^T dO and dK += dS^T Q * scale, dS = P o (dO V^T - D).
//   3. flash_bwd_dq_kernel: one block per (query head row, query block),
//      looping over the key blocks the forward visits:
//      dQ += dS K * scale.
// Every block owns its output rows and loops over its reduction axis, in an
// order fixed by the shapes: no atomics, so two launches on the same inputs
// give the same bits. Accumulation is float32.
//
// Rounding, as the forward rounds p before its AV product: on the bf16
// path P and dS are rounded to bf16 as the A operand of the tensor-core
// products dV += P^T dO, dK += dS^T Q and dQ += dS K; S and dP are float32
// products of the bf16 inputs. The float32 path rounds nothing. A query row
// with no unmasked key is undefined, as in the forward.
//
// Work: a block of 64 rows (4 warps x 16) on both axes. bf16 products run
// on mma.sync m16n8k16 (bf16 in, float32 accumulate) with fragments read
// from padded shared memory (rows of hd + 8 elements: conflict-free 32-bit
// fragment loads); the float32 path runs the same fragment layout through
// FMAs (P and dS through a per-warp shared scratch for the second product).
// Registers hold dK/dV for at most 128 columns: at hd 256 the dK/dV
// grid splits the columns in two (z), each block recomputing S and dP over
// the whole hd. Shared memory: K, V, Q and dO tiles (135,680 bytes at hd
// 256, bf16; the float32 path takes 32-row blocks at hd 256 to stay under
// the 227 KB opt-in).
//
// Bound: operations. 10 hd FLOP per unmasked (q, k) pair (S and dP to
// recompute, dV, dK and dQ), at the bf16 tensor-core rate on that path.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() (or the error of a
// shared-memory opt-in, made once per device at the first launch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
struct Pad;
template <>
struct Pad<float> {
  static constexpr int kElems = 4;   // 16 bytes
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int kElems = 8;   // 16 bytes
};

// Tiling of one (element type, head dim).
template <typename T, int HD>
struct Bwd {
  static constexpr int kBlock = (sizeof(T) == 4 && HD > 128) ? 32 : 64;  // rows of a tile
  static constexpr int kWarps = kBlock / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStride = HD + Pad<T>::kElems;   // shared-memory row, elements
  static constexpr int kNT = kBlock / 8;                // 8-column tiles of a score tile
  static constexpr int kCW = HD > 128 ? 128 : HD;       // dK/dV columns a block holds
  static constexpr int kSplit = HD / kCW;
  static constexpr size_t kTileBytes = sizeof(T) * kBlock * kStride;
  // float32 only: each warp's 16 x kBlock probability tile (rows padded by
  // one), read back by gemm_pv
  static constexpr int kPStride = kBlock + 1;
  static constexpr size_t kScratch = sizeof(T) == 4 ? sizeof(float) * kWarps * 16 * kPStride : 0;
  static constexpr size_t kSmem = 4 * kTileBytes + 2 * sizeof(float) * kBlock + kScratch;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows r0 .. r0 + kBlock - 1 of one head's (n_rows, HD) matrix into a
// padded shared tile, 16 bytes a thread at a time; rows past n_rows are 0.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int n_rows) {
  using B = Bwd<T, HD>;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecsRow = HD / kVec;
  for (int i = threadIdx.x; i < B::kBlock * kVecsRow; i += B::kThreads) {
    const int r = i / kVecsRow;
    const int c = (i % kVecsRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * B::kStride + c) = val;
  }
}

// ---------------------------------------------------------------------------
// Warp-level tile products in the m16n8 fragment layout (lane l, g = l / 4,
// t = l % 4): a 16 x 8 float32 tile's elements 0, 1 sit at row g, columns
// 2t, 2t + 1; elements 2, 3 at row g + 8.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of one column from two rows, the first in the low half.
__device__ __forceinline__ uint32_t pack_rows(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c[16 x 8 NT] += A[16 x HD] * Bm[8 NT x HD]^T; A and Bm are shared tiles of
// row stride S (rows a[0..15], b[0..8 NT - 1]).
template <int HD, int S, int NT>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    const uint32_t a0 = ld32(a + g * S + kk + 2 * t);
    const uint32_t a1 = ld32(a + (g + 8) * S + kk + 2 * t);
    const uint32_t a2 = ld32(a + g * S + kk + 8 + 2 * t);
    const uint32_t a3 = ld32(a + (g + 8) * S + kk + 8 + 2 * t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* bp = b + (8 * n + g) * S + kk + 2 * t;
      mma16816(c[n], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
    }
  }
}

template <int HD, int S, int NT>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4], const float* a, const float* b,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < HD; ++k) {
    const float a0 = a[g * S + k];
    const float a1 = a[(g + 8) * S + k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = b[(8 * n + 2 * t) * S + k];
      const float b1 = b[(8 * n + 2 * t + 1) * S + k];
      c[n][0] = fmaf(a0, b0, c[n][0]);
      c[n][1] = fmaf(a0, b1, c[n][1]);
      c[n][2] = fmaf(a1, b0, c[n][2]);
      c[n][3] = fmaf(a1, b1, c[n][3]);
    }
  }
}

// c[16 x 8 NC] += P[16 x 8 NT] * Bm[8 NT rows, columns col0 .. col0 + 8 NC);
// P is a float32 tile in registers (fragment layout), Bm a shared tile of
// row stride S. bf16: P is rounded to bf16 as the A operand. float32: P
// goes through the warp's shared scratch (16 rows of stride 8 NT + 1) and
// the sum runs over k in order.
template <int S, int NT, int NC>
__device__ __forceinline__ void gemm_pv(float (&c)[NC][4], const float (&p)[NT][4],
                                        const __nv_bfloat16* b, int col0, int lane, float*) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    // The float32 layout of P's columns 16 j .. 16 j + 15 is the A
    // fragment of a k-step.
    const uint32_t a0 = pack_f32(p[2 * j][0], p[2 * j][1]);
    const uint32_t a1 = pack_f32(p[2 * j][2], p[2 * j][3]);
    const uint32_t a2 = pack_f32(p[2 * j + 1][0], p[2 * j + 1][1]);
    const uint32_t a3 = pack_f32(p[2 * j + 1][2], p[2 * j + 1][3]);
    const __nv_bfloat16* row = b + (16 * j + 2 * t) * S + col0 + g;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const __nv_bfloat16* bp = row + 8 * n;
      mma16816(c[n], a0, a1, a2, a3, pack_rows(bp, bp + S), pack_rows(bp + 8 * S, bp + 9 * S));
    }
  }
}

template <int S, int NT, int NC>
__device__ __forceinline__ void gemm_pv(float (&c)[NC][4], const float (&p)[NT][4],
                                        const float* b, int col0, int lane, float* scratch) {
  constexpr int PS = 8 * NT + 1;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();   // the warp's last reads of the scratch are done
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    scratch[g * PS + 8 * n + 2 * t] = p[n][0];
    scratch[g * PS + 8 * n + 2 * t + 1] = p[n][1];
    scratch[(g + 8) * PS + 8 * n + 2 * t] = p[n][2];
    scratch[(g + 8) * PS + 8 * n + 2 * t + 1] = p[n][3];
  }
  __syncwarp();
#pragma unroll 2
  for (int k = 0; k < 8 * NT; ++k) {
    const float p0 = scratch[g * PS + k];
    const float p1 = scratch[(g + 8) * PS + k];
    const float* row = b + k * S + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float b0 = row[8 * n];
      const float b1 = row[8 * n + 1];
      c[n][0] = fmaf(p0, b0, c[n][0]);
      c[n][1] = fmaf(p0, b1, c[n][1]);
      c[n][2] = fmaf(p1, b0, c[n][2]);
      c[n][3] = fmaf(p1, b1, c[n][3]);
    }
  }
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int Sq, int kv_len, int causal,
                                        int window) {
  bool ok = k_pos < kv_len && q_pos < Sq;
  if (causal) ok = ok && k_pos <= q_pos;
  if (window > 0) ok = ok && (q_pos - k_pos) < window;
  return ok;
}

// ---------------------------------------------------------------------------
// 1. D_i = sum_d dout_i * out_i: one warp a row, 8 rows a block.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                     float* __restrict__ dvec, int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * HD;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32) acc = fmaf(to_f(out[base + c]), to_f(dout[base + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) dvec[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK, dV: block (KV row, key block, column slice); warp w owns keys
//    k0 + 16 w .. + 15 and works on S^T (keys x queries).
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(Bwd<T, HD>::kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
                      int Sq, int Sk, int group, int causal, int window, int kv_len,
                      float sm_scale) {
  using B = Bwd<T, HD>;
  constexpr int S = B::kStride, NT = B::kNT, NC = B::kCW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + B::kBlock * S;
  T* Qs = Vs + B::kBlock * S;
  T* Os = Qs + B::kBlock * S;   // dO
  float* lse_s = reinterpret_cast<float*>(Os + B::kBlock * S);   // log2 units
  float* d_s = lse_s + B::kBlock;
  float* scratch = d_s + B::kBlock + (threadIdx.x / 32) * 16 * B::kPStride;   // float32 path

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * B::kBlock;
  const int col0 = blockIdx.z * B::kCW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = sm_scale * kLog2e;

  load_tile<T, HD>(Ks, k + static_cast<size_t>(kvh) * Sk * HD, k0, Sk);
  load_tile<T, HD>(Vs, v + static_cast<size_t>(kvh) * Sk * HD, k0, Sk);

  float dka[NC][4], dva[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // Query blocks holding a query that can see a key of this block.
  const int key0 = k0 + 16 * warp + g;   // and key0 + 8
  int q_begin = causal ? k0 : 0;
  int q_end = Sq;
  if (window > 0) q_end = min(q_end, k0 + B::kBlock - 1 + window);
  if (k0 >= kv_len) q_end = 0;
  q_begin = (q_begin / B::kBlock) * B::kBlock;

  for (int gi = 0; gi < group; ++gi) {
    const size_t bh = static_cast<size_t>(kvh) * group + gi;
    for (int qb = q_begin; qb < q_end; qb += B::kBlock) {
      __syncthreads();   // every warp is done with the previous Q / dO tiles
      load_tile<T, HD>(Qs, q + bh * Sq * HD, qb, Sq);
      load_tile<T, HD>(Os, dout + bh * Sq * HD, qb, Sq);
      for (int i = threadIdx.x; i < B::kBlock; i += B::kThreads) {
        const bool in = qb + i < Sq;
        lse_s[i] = in ? lse[bh * Sq + qb + i] * kLog2e : 0.f;
        d_s[i] = in ? dvec[bh * Sq + qb + i] : 0.f;
      }
      __syncthreads();

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      gemm_nt<HD, S, NT>(s, Ks + 16 * warp * S, Qs, lane);    // S^T = K Q^T
      gemm_nt<HD, S, NT>(dp, Vs + 16 * warp * S, Os, lane);   // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t + (e & 1);
          const int key = e < 2 ? key0 : key0 + 8;
          const float p = visible(qb + qi, key, Sq, kv_len, causal, window)
                              ? exp2f(s[n][e] * scale_log2 - lse_s[qi])
                              : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - d_s[qi]);   // dS^T
        }
      gemm_pv<S, NT, NC>(dva, s, Os, col0, lane, scratch);    // dV += P^T dO
      gemm_pv<S, NT, NC>(dka, dp, Qs, col0, lane, scratch);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = e < 2 ? key0 : key0 + 8;
      if (key >= Sk) continue;
      const size_t at = (static_cast<size_t>(kvh) * Sk + key) * HD + col0 + 8 * n + 2 * t + (e & 1);
      dk[at] = from_f<T>(dka[n][e] * sm_scale);
      dv[at] = from_f<T>(dva[n][e]);
    }
}

// ---------------------------------------------------------------------------
// 3. dQ: block (query head row, query block); warp w owns queries
//    q0 + 16 w .. + 15 and works on S (queries x keys).
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(Bwd<T, HD>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq, int Sq, int Sk,
                    int group, int causal, int window, int kv_len, float sm_scale) {
  using B = Bwd<T, HD>;
  constexpr int S = B::kStride, NT = B::kNT, NC = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Os = Qs + B::kBlock * S;   // dO
  T* Ks = Os + B::kBlock * S;
  T* Vs = Ks + B::kBlock * S;
  // past the two float rows the dK/dV kernel keeps: the float32 scratch
  float* scratch = reinterpret_cast<float*>(Vs + B::kBlock * S) + 2 * B::kBlock +
                   (threadIdx.x / 32) * 16 * B::kPStride;

  const size_t bh = blockIdx.x;
  const int kvh = static_cast<int>(bh) / group;
  const int q0 = blockIdx.y * B::kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = sm_scale * kLog2e;

  load_tile<T, HD>(Qs, q + bh * Sq * HD, q0, Sq);
  load_tile<T, HD>(Os, dout + bh * Sq * HD, q0, Sq);
  const int row0 = q0 + 16 * warp + g;   // and row0 + 8
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse2[h] = row < Sq ? lse[bh * Sq + row] * kLog2e : 0.f;
    dd[h] = row < Sq ? dvec[bh * Sq + row] : 0.f;
  }

  float dqa[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  // Key blocks the forward visits for this query block.
  const int q_last = min(q0 + B::kBlock, Sq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / B::kBlock) * B::kBlock;

  for (int kb = k_begin; kb < k_end; kb += B::kBlock) {
    __syncthreads();   // Q / dO loaded, and every warp done with the last K / V
    load_tile<T, HD>(Ks, k + static_cast<size_t>(kvh) * Sk * HD, kb, Sk);
    load_tile<T, HD>(Vs, v + static_cast<size_t>(kvh) * Sk * HD, kb, Sk);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    gemm_nt<HD, S, NT>(s, Qs + 16 * warp * S, Ks, lane);    // S = Q K^T
    gemm_nt<HD, S, NT>(dp, Os + 16 * warp * S, Vs, lane);   // dP = dO V^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = kb + 8 * n + 2 * t + (e & 1);
        const float p = visible(row0 + 8 * h, key, Sq, kv_len, causal, window)
                            ? exp2f(s[n][e] * scale_log2 - lse2[h])
                            : 0.f;
        dp[n][e] = p * (dp[n][e] - dd[h]);   // dS
      }
    gemm_pv<S, NT, NC>(dqa, dp, Ks, 0, lane, scratch);   // dQ += dS K
  }

#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1);
      if (row >= Sq) continue;
      dq[(bh * Sq + row) * HD + 8 * n + 2 * t + (e & 1)] = from_f<T>(dqa[n][e] * sm_scale);
    }
}

// Opt a kernel in to its dynamic shared memory once per device.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, int device, bool (&done)[kMaxDevices]) {
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) done[device] = true;
  return err;
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* dvec, void* dq, void* dk, void* dv, int BH, int Sq, int Sk,
               int group, int causal, int window, int kv_len, float sm_scale, int device,
               cudaStream_t s) {
  using B = Bwd<T, HD>;
  static bool done_kv[kMaxDevices] = {};
  static bool done_q[kMaxDevices] = {};
  cudaError_t err = opt_in_smem(flash_bwd_dkdv_kernel<T, HD>, B::kSmem, device, done_kv);
  if (err == cudaSuccess) err = opt_in_smem(flash_bwd_dq_kernel<T, HD>, B::kSmem, device, done_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dvt = static_cast<float*>(dvec);
  flash_bwd_dot_kernel<T, HD><<<ceil_div(BH * Sq, 8), 256, 0, s>>>(
      static_cast<const T*>(out), dot, dvt, BH * Sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(BH / group, ceil_div(Sk, B::kBlock), B::kSplit);
  flash_bwd_dkdv_kernel<T, HD><<<grid_kv, B::kThreads, B::kSmem, s>>>(
      qt, kt, vt, dot, lt, dvt, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, group, causal,
      window, kv_len, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(BH, ceil_div(Sq, B::kBlock));
  flash_bwd_dq_kernel<T, HD><<<grid_q, B::kThreads, B::kSmem, s>>>(
      qt, kt, vt, dot, lt, dvt, static_cast<T*>(dq), Sq, Sk, group, causal, window, kv_len,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// hd in {32, 64, 128, 256}; bf16 != 0 for bfloat16 tensors, else float32;
// window 0 means no window; 0 <= kv_len <= Sk; BH, Sq, Sk > 0. Every tensor
// starts on a 16-byte boundary (tiles load 16 bytes a thread). dvec is a
// float32 (BH, Sq) scratch. Returns 0 or a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const void* lse, void* dvec, void* dq, void* dk,
                        void* dv, int BH, int Sq, int Sk, int hd, int group, int causal,
                        int window, int kv_len, int bf16, float sm_scale, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_CASE(HD)                                                                          \
  case HD:                                                                                    \
    return bf16 ? launch_bwd<__nv_bfloat16, HD>(q, k, v, out, dout, lse, dvec, dq, dk, dv, BH, \
                                                Sq, Sk, group, causal, window, kv_len,         \
                                                sm_scale, device, s)                           \
                : launch_bwd<float, HD>(q, k, v, out, dout, lse, dvec, dq, dk, dv, BH, Sq, Sk, \
                                        group, causal, window, kv_len, sm_scale, device, s);
  switch (hd) {
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_CASE
}

}  // extern "C"
