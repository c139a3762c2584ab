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
//   dvec     float32 scratch    D_i = sum_d dout_i * out_i: (BH, Sq), or on
//                               the wgmma path (BH, ceil(Sq / 64), 2, 64)
//                               row tiles of LSE_i log2 e and D_i, 0 past Sq
// All of q, k, v, out, dout, dq, dk, dv are bf16, or all float32.
//
// The two-pass FlashAttention-2 backward, in three launches:
//   1. flash_bwd_dot_kernel (flash_bwd_dot_tiles_kernel on the wgmma
//      path): D_i, one warp a row (reads dO and O once).
//   2. dK, dV: one block per (KV row, key block). It loops over the group's
//      G query head rows and every query tile that can see its keys,
//      recomputes P^T = exp(S^T * scale - LSE) under the forward's mask
//      (-> 0 where masked), and accumulates dV += P^T dO and
//      dK += dS^T Q * scale, dS = P o (dO V^T - D).
//   3. dQ: one block per (query head row, query block), looping over the
//      key tiles the forward visits: dQ += dS K * scale.
// Every block owns its output rows and loops over its reduction axis, in an
// order fixed by the shapes: no atomics, and no block waits on another, so
// two launches on the same inputs give the same bits. S and dP are computed
// in both 2 and 3 (14 hd FLOP of tensor work a pair against the 10 hd that
// bound it): folding dQ into 2 would need atomics (no bit-equal resume) or
// blocks that wait on each other's counters. Accumulation is float32.
//
// Rounding, as the forward rounds p before its AV product: on the bf16
// path P and dS are rounded to bf16 as the A operand of the tensor-core
// products dV += P^T dO, dK += dS^T Q and dQ += dS K; S and dP are float32
// products of the bf16 inputs. The float32 path rounds nothing. A query row
// with no unmasked key is undefined, as in the forward.
//
// Bound: operations. 10 hd FLOP per unmasked (q, k) pair (S and dP to
// recompute, dV, dK and dQ), at the bf16 tensor-core rate on that path.
//
// Three paths, an explicit choice by dtype and head dim:
//
// bf16, hd 32 / 64 / 128 (the trained models): warpgroup MMA fed by TMA,
// the forward's machinery. Both kernels run two consumer warpgroups a
// block, each owning 64 of the block's 128 rows; the block's own rows (K
// and V in 2, Q and dO in 3) are loaded once by TMA, and the streamed
// operand (Q, dO and that tile's 64 LSE and D values in 2; K and V in 3)
// arrives in 64-row tiles through a 3-stage ring. At the top of iteration
// i thread 0 starts tile i + 2 (cp.async.bulk.tensor, completion on the
// stage's "full" mbarrier) once every warp has released tile i - 1 (its
// stage's "empty" mbarrier), so loads run two tiles ahead of the products
// and the warpgroups may drift apart by one tile. Every product is one of
// the forward's two wgmma m64n64k16 forms: S^T = K Q^T and dP^T = V dO^T
// (2), S = Q K^T and dP = dO V^T (3) with both operands K-major in
// 128-byte-swizzled shared memory; dV += P^T dO, dK += dS^T Q (2) and
// dQ += dS K (3) with P / dS rounded to bf16 straight from the accumulator
// layout into register A fragments and B read MN-major from its tile (no
// transposed copy, no fragment loads from shared memory). S and dP are
// committed as two groups, so P's exponentials run under dP's product, and
// in 2 dV's product runs while dS is formed. Tiles wholly outside the
// causal or window band, or past kv_len, are not visited; masks (two
// integer bounds a row) are applied only on tiles that cross an edge; the
// heaviest blocks run first. Registers hold a warpgroup's two 64 x hd
// float32 accumulators (128 a thread at hd 128) with S and dP beside them;
// one 256-thread block an SM. Head dims under 64 are staged 64 wide (the
// TMA box zero-fills the columns past hd, which no store writes). Shared
// memory at hd 128: 166,456 bytes (dK/dV) and 164,920 (dQ). The D launch
// reads O and dO 16 bytes a thread and writes LSE log2 e and D into 64-row
// tiles (zeros past Sq), each a stage's one 512-byte bulk copy.
//
// bf16, hd 256: the first version's mma.sync m16n8k16 kernels, kept as an
// explicit dispatch by head dim: a 64-row warpgroup's dK and dV
// accumulators (2 x 128 registers a thread) do not fit beside S and dP.
// Blocks of 64 rows on 4 warps, fragments read from padded shared memory,
// the dK/dV grid split over two column halves (z), each recomputing S and
// dP. No trainable family has hd 256.
//
// float32 (off the training path): the same fragment layout through FMAs,
// tiles staged synchronously in padded shared memory (32-row blocks at hd
// 256 to stay under the 227 KB opt-in).
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() (or the error of a
// shared-memory opt-in, made once per device at the first launch, or a
// negative code of the tensor-map encoder).
#include <cuda.h>
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

// ---------------------------------------------------------------------------
// bf16 at hd 32 / 64 / 128: warpgroup MMA (wgmma) on tensor cores, the
// streamed operand through a TMA ring. The primitives are the forward's
// (flash_attention.cu), carried over as they are.
// ---------------------------------------------------------------------------
constexpr int kBwdBlock = 128;   // rows a block owns: two consumer warpgroups of 64
constexpr int kBwdTile = 64;     // rows of a streamed tile
constexpr int kBwdStages = 3;    // ring depth
constexpr int kBwdAhead = 2;     // tiles started ahead of the one computed
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kSwizzleBytes = 128;  // one swizzled row: 64 bf16
constexpr int kSwizzleCols = 64;

template <int HD>
__host__ __device__ constexpr int padded_hd() { return HD < kSwizzleCols ? kSwizzleCols : HD; }

// Shared memory of one block: 1024 bytes of slack to align the base to the
// 128-byte swizzle's 1024-byte atom; the block's two held tiles (kBwdBlock
// rows each: K and V in dK/dV, Q and dO in dQ); kBwdStages stages of two
// streamed tiles (kBwdTile rows: Q and dO, or K and V); in dK/dV each
// stage's 64 LSE log2 e and 64 D values (float32, one run of the row
// tiles below); then the mbarriers: the held tiles', and a full and an
// empty one a stage. Every tile is a run of 64-column blocks of 128-byte
// swizzled rows.
template <int HD, bool kRows>
struct BwdLayout {
  static constexpr int kColBlocks = padded_hd<HD>() / kSwizzleCols;
  static constexpr uint32_t kHeldBlock = kBwdBlock * kSwizzleBytes;   // one 64-column block
  static constexpr uint32_t kTileBlock = kBwdTile * kSwizzleBytes;
  static constexpr uint32_t kHeldBytes = kColBlocks * kHeldBlock;     // one held tile
  static constexpr uint32_t kTileBytes = kColBlocks * kTileBlock;     // one streamed tile
  static constexpr uint32_t kRing = 2 * kHeldBytes;
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr uint32_t kRowBytes = 2 * 4 * kBwdTile;   // 64 LSE log2 e, then 64 D
  static constexpr uint32_t kRowsOffset = kRing + kBwdStages * kStageBytes;
  static constexpr uint32_t kBarOffset = kRowsOffset + (kRows ? kBwdStages * kRowBytes : 0);
  static constexpr uint32_t kStageTx = kStageBytes + (kRows ? kRowBytes : 0);
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kBwdStages);
};
template <int HD>
using DkdvLayout = BwdLayout<HD, true>;
template <int HD>
using DqLayout = BwdLayout<HD, false>;

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// A bulk copy of `bytes` contiguous bytes (16-byte aligned at both ends).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// Groups of 8 rows are 1024 bytes apart in every tile here.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64x64, f32) (+)= A(64x16, smem, K-major) * B(16x64, smem, K-major).
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64x64, f32) += A(64x16, bf16 registers) * B(16x64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_64x64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc(64 x 64) (+)= A B^T over hd, both operands K-major swizzled tiles: A
// the warpgroup's 64 rows of a tile whose column blocks are a_block bytes
// apart, B a streamed or held tile with blocks b_block apart. A k-step of
// 16 moves 32 bytes along a swizzled row; four of them a whole block.
template <int HD>
__device__ __forceinline__ void gemm_ss(float (&acc)[32], uint32_t a, uint32_t a_block,
                                        uint32_t b, uint32_t b_block) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_64x64(acc, sw128_desc(a + (kk / 4) * a_block + off, 0, 1024),
                   sw128_desc(b + (kk / 4) * b_block + off, 0, 1024), kk > 0);
  }
}

// acc[c](64 x 64 columns of block c) += A(64 x 64, bf16 registers, one
// fragment a k-step) B, B the kBwdTile-row tile at b read MN-major: 16 rows
// a k-step are 2048 bytes, a 64-column block kTileBlock. With one
// 64-column block an instruction the leading byte offset is never used.
template <int NB>
__device__ __forceinline__ void gemm_rs(float (&acc)[NB][32], const uint32_t (&a)[4][4],
                                        uint32_t b, uint32_t b_block) {
#pragma unroll
  for (int kk = 0; kk < kBwdTile / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NB; ++c)
      wgmma_rs_64x64(acc[c], a[kk], sw128_desc(b + c * b_block + kk * 2048, 1024, 1024));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit, subnormal results flushed to 0 (one
// instruction; exp2f adds a range fix-up around it).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kIntMin = -2147483647 - 1;
constexpr int kIntMax = 2147483647;

// The accumulator layout of a 64 x 64 tile's columns 16 kk .. 16 kk + 15,
// rounded to bf16, is the register A fragment of k-step kk.
__device__ __forceinline__ void to_a_fragments(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Start the TMA loads of streamed tile j of the dK/dV ring: query tile
// q0 .. q0 + 63 of query head row bh (Q, dO, and its run of the row tiles)
// into stage j % stages.
template <int HD>
__device__ __forceinline__ void load_q_tile(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const float* rows, uint32_t base, int j, int q0,
                                            int bh, int n_qt_all) {
  using L = DkdvLayout<HD>;
  const int st = j % kBwdStages;
  const uint32_t stage = base + L::kRing + st * L::kStageBytes;
  const uint32_t s_rows = base + L::kRowsOffset + st * L::kRowBytes;
  const uint32_t bar = base + L::kBarOffset + 8 * (1 + st);
  mbar_expect_tx(bar, L::kStageTx);
  for (int b = 0; b < L::kColBlocks; ++b) {
    tma_load_3d(stage + b * L::kTileBlock, tm_q, bar, b * kSwizzleCols, q0, bh);
    tma_load_3d(stage + L::kTileBytes + b * L::kTileBlock, tm_do, bar, b * kSwizzleCols, q0, bh);
  }
  bulk_load(s_rows, rows + (static_cast<size_t>(bh) * n_qt_all + q0 / kBwdTile) * 2 * kBwdTile,
            L::kRowBytes, bar);
}

// The same for streamed tile j of the dQ ring: keys k0 .. k0 + 63 of KV
// row kvh (K, V).
template <int HD>
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             uint32_t base, int j, int k0, int kvh) {
  using L = DqLayout<HD>;
  const int st = j % kBwdStages;
  const uint32_t stage = base + L::kRing + st * L::kStageBytes;
  const uint32_t bar = base + L::kBarOffset + 8 * (1 + st);
  mbar_expect_tx(bar, L::kStageTx);
  for (int b = 0; b < L::kColBlocks; ++b) {
    tma_load_3d(stage + b * L::kTileBlock, tm_k, bar, b * kSwizzleCols, k0, kvh);
    tma_load_3d(stage + L::kTileBytes + b * L::kTileBlock, tm_v, bar, b * kSwizzleCols, k0, kvh);
  }
}

// The held tiles' two loads (kBwdBlock rows at r0 of head h).
template <int HD, bool kRows>
__device__ __forceinline__ void load_held(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                          uint32_t base, int r0, int h) {
  using L = BwdLayout<HD, kRows>;
  const uint32_t bar = base + L::kBarOffset;
  mbar_expect_tx(bar, 2 * L::kHeldBytes);
  for (int b = 0; b < L::kColBlocks; ++b) {
    tma_load_3d(base + b * L::kHeldBlock, tm_a, bar, b * kSwizzleCols, r0, h);
    tma_load_3d(base + L::kHeldBytes + b * L::kHeldBlock, tm_b, bar, b * kSwizzleCols, r0, h);
  }
}

__device__ __forceinline__ void init_ring(uint32_t bars) {
  mbar_init(bars, 1);
  for (int s = 0; s < kBwdStages; ++s) {
    mbar_init(bars + 8 * (1 + s), 1);                       // full: the producer's expect_tx
    mbar_init(bars + 8 * (1 + kBwdStages + s), kBwdWarps);  // empty: one arrival a warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's step at the top of iteration i (thread 0 only, with no
// product in flight: a branch inside a wgmma window makes ptxas serialize
// every wgmma of the kernel): start tile i + kBwdAhead once every warp has
// released the stage it lands in (tile i + kBwdAhead - kBwdStages's). The
// running index i walks the whole ring, so the parities follow it and not
// a tile index.
__device__ __forceinline__ bool next_load(uint32_t bars, int i, int n, int* j) {
  *j = i + kBwdAhead;
  if (*j >= n) return false;
  if (*j >= kBwdStages)
    mbar_wait(bars + 8 * (1 + kBwdStages + *j % kBwdStages), ((*j / kBwdStages) - 1) & 1);
  return true;
}

// Accumulator fragment of m64nN (per warpgroup thread t, warp w = t / 32,
// lane l): element j of an n64 tile sits at row 16 w + l / 4 + 8 * ((j / 2) % 2)
// and column 8 (j / 4) + 2 (l % 4) + j % 2. Each thread holds two rows; the
// four lanes of a quad hold a row's 64 columns between them.

// 2. dK, dV: block (KV row, kBwdBlock keys); warpgroup wg owns keys
//    kw0 = k0 + 64 wg .. + 63 and works on S^T (keys x queries), so an
//    element's query, and its LSE and D, is its column.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ rows, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int group, int causal,
                            int window, int kv_len, float sm_scale) {
  using L = DkdvLayout<HD>;
  constexpr int NB = L::kColBlocks;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const float* rows_s =
      reinterpret_cast<const float*>(smem_raw + (base - smem_u32(smem_raw)) + L::kRowsOffset);
  const uint32_t bars = base + L::kBarOffset;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * kBwdBlock;   // causal: the lowest keys, seen by most queries, first
  const float scale_log2 = sm_scale * kLog2e;

  // Query tiles holding a query that can see a key of this block; the ring
  // walks (query head g of the group, query tile) in one sequence.
  const int q_begin = causal ? k0 : 0;
  int q_end = k0 < kv_len ? Sq : 0;
  if (window > 0) q_end = min(q_end, k0 + kBwdBlock - 1 + window);
  const int qt_begin = q_begin / kBwdTile;
  const int n_qt = q_end > q_begin ? (q_end + kBwdTile - 1) / kBwdTile - qt_begin : 0;
  const int n = group * n_qt;
  const int n_qt_all = (Sq + kBwdTile - 1) / kBwdTile;   // row tiles a query head row

  if (tid == 0) init_ring(bars);
  __syncthreads();
  if (tid == 0 && n > 0) {
    load_held<HD, true>(&tm_k, &tm_v, base, k0, kvh);
    for (int j = 0; j < kBwdAhead && j < n; ++j)
      load_q_tile<HD>(&tm_q, &tm_do, rows, base, j, (qt_begin + j % n_qt) * kBwdTile,
                      kvh * group + j / n_qt, n_qt_all);
  }

  float dka[NB][32], dva[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[c][e] = dva[c][e] = 0.f;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * warp + lane / 4;   // and key0 + 8
  const int col_lane = 2 * (lane % 4);
  const uint32_t s_k = base + wg * 64 * kSwizzleBytes;
  const uint32_t s_v = s_k + L::kHeldBytes;

  if (n > 0) mbar_wait(bars, 0);
  for (int i = 0; i < n; ++i) {
    int j;
    if (tid == 0 && next_load(bars, i, n, &j))
      load_q_tile<HD>(&tm_q, &tm_do, rows, base, j, (qt_begin + j % n_qt) * kBwdTile,
                      kvh * group + j / n_qt, n_qt_all);
    const int st = i % kBwdStages;
    const int q0 = (qt_begin + i % n_qt) * kBwdTile;
    const uint32_t s_q = base + L::kRing + st * L::kStageBytes;
    const uint32_t s_do = s_q + L::kTileBytes;
    // Does the tile hold a pair the mask lets through for this warpgroup?
    const bool live = kw0 < kv_len && (!causal || q0 + kBwdTile - 1 >= kw0) &&
                      (window <= 0 || q0 - (kw0 + 63) < window);
    mbar_wait(bars + 8 * (1 + st), (i / kBwdStages) & 1);

    if (live) {
      // The mask (set before the products: no branch inside a wgmma window)
      // as two bounds a row on u = 8 c + e, the element's query
      // less q0 + col_lane: keep where lo[h] <= u < hi[h].
      const bool edge = (kw0 + 64 > kv_len) || (q0 + kBwdTile > Sq) ||
                        (causal && q0 < kw0 + 63) || (window > 0 && q0 + kBwdTile - 1 - kw0 >= window);
      int lo[2] = {kIntMin, kIntMin}, hi[2] = {kIntMax, kIntMax};
      if (edge) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int diag = key0 + 8 * h - (q0 + col_lane);   // u of the query at this key
          lo[h] = causal ? diag : kIntMin;
          hi[h] = min(Sq - (q0 + col_lane), window > 0 ? diag + window : kIntMax);
          if (key0 + 8 * h >= kv_len) hi[h] = kIntMin;
        }
      }
      // S^T = K Q^T and dP^T = V dO^T, two groups: P's exponentials run
      // while dP^T is still on the tensor cores.
      float s[32], dp[32];
      wgmma_fence();
      gemm_ss<HD>(s, s_k, L::kHeldBlock, s_q, L::kTileBlock);
      wgmma_commit();
      gemm_ss<HD>(dp, s_v, L::kHeldBlock, s_do, L::kTileBlock);
      wgmma_commit();
      wgmma_wait_one();
      fence_regs(s);
      // P^T = 2^(S^T scale log2 e - LSE log2 e), 0 where masked (a select:
      // exp2 of a masked score may be inf).
      const float* lse_s = rows_s + st * 2 * kBwdTile;
      const float* d_s = lse_s + kBwdTile;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * c + col_lane);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float nl = -(e ? l2.y : l2.x);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * c + 2 * h + e;
            const int u = 8 * c + e;
            const float p = exp2_ftz(fmaf(s[x], scale_log2, nl));
            s[x] = (u >= lo[h] && u < hi[h]) ? p : 0.f;
          }
        }
      }
      uint32_t pa[4][4];
      to_a_fragments(pa, s);
      wgmma_wait_all();
      fence_regs(dp);
      // dV += P^T dO (dO read MN-major from the stage) while dS^T =
      // P^T o (dP^T - D) is formed; then dK += dS^T Q.
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(dva[c]);
      wgmma_fence();
      gemm_rs<NB>(dva, pa, s_do, L::kTileBlock);
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 dd = *reinterpret_cast<const float2*>(d_s + 8 * c + col_lane);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * c + 2 * h + e;
            dp[x] = s[x] * (dp[x] - (e ? dd.y : dd.x));
          }
      }
      uint32_t da[4][4];
      to_a_fragments(da, dp);
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(dka[c]);
      wgmma_fence();
      gemm_rs<NB>(dka, da, s_q, L::kTileBlock);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        fence_regs(dva[c]);
        fence_regs(dka[c]);
      }
    }
    // Release the stage: one arrival a warp, once its products are done.
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + kBwdStages + st));
  }

#pragma unroll
  for (int c = 0; c < NB; ++c) {
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int col = c * kSwizzleCols + 8 * cc + col_lane;
      if (col >= HD) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key0 + 8 * h;
        if (key >= Sk) continue;
        const size_t at = (static_cast<size_t>(kvh) * Sk + key) * HD + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            dka[c][4 * cc + 2 * h] * sm_scale, dka[c][4 * cc + 2 * h + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dva[c][4 * cc + 2 * h], dva[c][4 * cc + 2 * h + 1]);
      }
    }
  }
}

// 3. dQ: block (query head row, kBwdBlock queries); warpgroup wg owns
//    queries wq0 = q0 + 64 wg .. + 63 and works on S (queries x keys).
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ rows,
                          __nv_bfloat16* __restrict__ dq, int Sq, int group, int causal,
                          int window, int kv_len, float sm_scale) {
  using L = DqLayout<HD>;
  constexpr int NB = L::kColBlocks;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBarOffset;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int kvh = bh / group;
  // Heaviest query blocks (most keys in the band) first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdBlock;
  const float scale_log2 = sm_scale * kLog2e;

  // Key tiles the whole block needs (the band of its 128 rows), as the
  // forward visits them.
  const int q_last = min(q0 + kBwdBlock, Sq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBwdTile;
  const int n = k_end > k_begin ? (k_end + kBwdTile - 1) / kBwdTile - kt_begin : 0;

  // This warpgroup's 64 rows and their band.
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 64, Sq) - 1;
  int wk_end = wq0 < Sq ? kv_len : 0;
  if (causal) wk_end = min(wk_end, wq_last + 1);
  const int wk_begin = window > 0 ? max(0, wq0 - window + 1) : 0;

  if (tid == 0) init_ring(bars);
  __syncthreads();
  if (tid == 0 && n > 0) {
    load_held<HD, false>(&tm_q, &tm_do, base, q0, bh);
    for (int j = 0; j < kBwdAhead && j < n; ++j)
      load_kv_tile<HD>(&tm_k, &tm_v, base, j, (kt_begin + j) * kBwdTile, kvh);
  }

  const int row0 = wq0 + 16 * warp + lane / 4;   // and row0 + 8
  const int col_lane = 2 * (lane % 4);
  float nl[2], dd[2];   // -LSE log2 e and D of the thread's two rows
  const float* head_rows = rows + static_cast<size_t>(bh) * ((Sq + kBwdTile - 1) / kBwdTile) * 2 * kBwdTile;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const float* t = head_rows + (row / kBwdTile) * 2 * kBwdTile + row % kBwdTile;
    nl[h] = row < Sq ? -t[0] : 0.f;
    dd[h] = row < Sq ? t[kBwdTile] : 0.f;
  }
  float dqa[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dqa[c][e] = 0.f;
  const uint32_t s_q = base + wg * 64 * kSwizzleBytes;
  const uint32_t s_do = s_q + L::kHeldBytes;

  if (n > 0) mbar_wait(bars, 0);
  for (int i = 0; i < n; ++i) {
    int j;
    if (tid == 0 && next_load(bars, i, n, &j))
      load_kv_tile<HD>(&tm_k, &tm_v, base, j, (kt_begin + j) * kBwdTile, kvh);
    const int st = i % kBwdStages;
    const int k0 = (kt_begin + i) * kBwdTile;
    const uint32_t s_k = base + L::kRing + st * L::kStageBytes;
    const uint32_t s_v = s_k + L::kTileBytes;
    const bool live = k0 < wk_end && k0 + kBwdTile > wk_begin;
    mbar_wait(bars + 8 * (1 + st), (i / kBwdStages) & 1);

    if (live) {
      // The mask (set before the products), masked only where the tile
      // crosses the band's or the ragged edge (rows past Sq are never
      // stored), as two bounds a row on v = 8 (x / 4) + x % 2, the
      // element's key less k0 + col_lane: keep where lo[h] <= v < hi[h].
      const bool edge = (k0 + kBwdTile > kv_len) || (causal && k0 + kBwdTile - 1 > wq0) ||
                        (window > 0 && wq_last - k0 >= window);
      int lo[2] = {kIntMin, kIntMin}, hi[2] = {kIntMax, kIntMax};
      if (edge) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int diag = row0 + 8 * h - (k0 + col_lane);   // v of the key at this query
          lo[h] = window > 0 ? diag - window + 1 : kIntMin;
          hi[h] = min(kv_len - (k0 + col_lane), causal ? diag + 1 : kIntMax);
        }
      }
      // S = Q K^T and dP = dO V^T, two groups (P's exponentials under dP).
      float s[32], dp[32];
      wgmma_fence();
      gemm_ss<HD>(s, s_q, L::kHeldBlock, s_k, L::kTileBlock);
      wgmma_commit();
      gemm_ss<HD>(dp, s_do, L::kHeldBlock, s_v, L::kTileBlock);
      wgmma_commit();
      wgmma_wait_one();
      fence_regs(s);
      // P as in dK/dV.
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int h = (x / 2) % 2;
        const int v = 8 * (x / 4) + x % 2;
        const float p = exp2_ftz(fmaf(s[x], scale_log2, nl[h]));
        s[x] = (v >= lo[h] && v < hi[h]) ? p : 0.f;
      }
      wgmma_wait_all();
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < 32; ++x) dp[x] = s[x] * (dp[x] - dd[(x / 2) % 2]);   // dS
      uint32_t da[4][4];
      to_a_fragments(da, dp);
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(dqa[c]);
      wgmma_fence();
      gemm_rs<NB>(dqa, da, s_k, L::kTileBlock);   // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(dqa[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + kBwdStages + st));
  }

  __nv_bfloat16* qp = dq + static_cast<size_t>(bh) * Sq * HD;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int col = c * kSwizzleCols + 8 * cc + col_lane;
      if (col >= HD) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= Sq) continue;
        *reinterpret_cast<__nv_bfloat162*>(qp + static_cast<size_t>(row) * HD + col) =
            __floats2bfloat162_rn(dqa[c][4 * cc + 2 * h] * sm_scale,
                                  dqa[c][4 * cc + 2 * h + 1] * sm_scale);
      }
    }
  }
}

// 1. (bf16 wgmma path) D_i and LSE_i log2 e, hd / 8 threads a row (16-byte
//    loads), into row tiles: (BH, ceil(Sq / 64), [64 LSE log2 e, 64 D]) float32, rows past Sq
//    0, so a query tile's values are one aligned 512-byte run.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dot_tiles_kernel(const __nv_bfloat16* __restrict__ out,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           float* __restrict__ rows, int Sq, int n_qt_all, int n_rows) {
  constexpr int kLanes = HD / 8;   // threads a row, 16 bytes (8 bf16) of each operand apiece
  const int row = blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int sub = threadIdx.x % kLanes;
  const int bh = row / (n_qt_all * kBwdTile);
  const int qq = row % (n_qt_all * kBwdTile);
  float acc = 0.f, l2 = 0.f;
  if (row < n_rows && qq < Sq) {
    const size_t at = (static_cast<size_t>(bh) * Sq + qq) * HD + 8 * sub;
    const uint4 a = *reinterpret_cast<const uint4*>(out + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(pa[e]);
      const float2 fb = __bfloat1622float2(pb[e]);
      acc = fmaf(fa.y, fb.y, fmaf(fa.x, fb.x, acc));
    }
    l2 = lse[static_cast<size_t>(bh) * Sq + qq] * kLog2e;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (row < n_rows && sub == 0) {
    float* t = rows + (static_cast<size_t>(bh) * n_qt_all + qq / kBwdTile) * 2 * kBwdTile;
    t[qq % kBwdTile] = l2;
    t[kBwdTile + qq % kBwdTile] = acc;
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

// Error codes of the bf16 path beside cudaError_t's (all positive).
constexpr int kErrNoEncode = -1;   // no cuTensorMapEncodeTiled was found
constexpr int kErrEncode = -2;     // cuTensorMapEncodeTiled refused a tensor map

// A (rows, cols) bf16 matrix per head, n_heads of them, as a 3-D tensor map
// whose box is 64 columns (one 128-byte swizzled row) by box_rows rows.
// Rows past `rows` and columns past `cols` load as zeros.
int make_map(CUtensorMap* map, const void* ptr, int cols, int rows, int n_heads, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoEncode;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows > 0 ? rows : 1),
                              static_cast<cuuint64_t>(n_heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * (rows > 0 ? rows : 1) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kSwizzleCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int HD>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const void* lse, void* dvec, void* dq, void* dk, void* dv,
                     int BH, int Sq, int Sk, int group, int causal, int window, int kv_len,
                     float sm_scale, int device, cudaStream_t s) {
  static bool done_kv[kMaxDevices] = {};
  static bool done_q[kMaxDevices] = {};
  cudaError_t err =
      opt_in_smem(flash_bwd_dkdv_wgmma_kernel<HD>, DkdvLayout<HD>::kSmem, device, done_kv);
  if (err == cudaSuccess)
    err = opt_in_smem(flash_bwd_dq_wgmma_kernel<HD>, DqLayout<HD>::kSmem, device, done_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kv = BH / group;
  // the held tiles' maps (kBwdBlock rows) and the streamed tiles' (kBwdTile)
  CUtensorMap tm_k_held, tm_v_held, tm_q_tile, tm_do_tile;
  CUtensorMap tm_q_held, tm_do_held, tm_k_tile, tm_v_tile;
  int rc = make_map(&tm_k_held, k, HD, Sk, n_kv, kBwdBlock);
  if (rc == 0) rc = make_map(&tm_v_held, v, HD, Sk, n_kv, kBwdBlock);
  if (rc == 0) rc = make_map(&tm_q_tile, q, HD, Sq, BH, kBwdTile);
  if (rc == 0) rc = make_map(&tm_do_tile, dout, HD, Sq, BH, kBwdTile);
  if (rc == 0) rc = make_map(&tm_q_held, q, HD, Sq, BH, kBwdBlock);
  if (rc == 0) rc = make_map(&tm_do_held, dout, HD, Sq, BH, kBwdBlock);
  if (rc == 0) rc = make_map(&tm_k_tile, k, HD, Sk, n_kv, kBwdTile);
  if (rc == 0) rc = make_map(&tm_v_tile, v, HD, Sk, n_kv, kBwdTile);
  if (rc != 0) return rc;
  const int n_qt_all = ceil_div(Sq, kBwdTile);
  const int n_rows = BH * n_qt_all * kBwdTile;
  float* rows = static_cast<float*>(dvec);
  flash_bwd_dot_tiles_kernel<HD><<<ceil_div(n_rows, 256 / (HD / 8)), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), rows, Sq, n_qt_all, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_wgmma_kernel<HD>
      <<<dim3(n_kv, ceil_div(Sk, kBwdBlock)), kBwdThreads, DkdvLayout<HD>::kSmem, s>>>(
          tm_k_held, tm_v_held, tm_q_tile, tm_do_tile, rows, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sk, group,
          causal, window, kv_len, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma_kernel<HD>
      <<<dim3(BH, ceil_div(Sq, kBwdBlock)), kBwdThreads, DqLayout<HD>::kSmem, s>>>(
          tm_q_held, tm_do_held, tm_k_tile, tm_v_tile, rows, static_cast<__nv_bfloat16*>(dq), Sq,
          group, causal, window, kv_len, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory each kernel opts in to: kernel 0 dK/dV, 1 dQ.
size_t smem_of(int hd, bool bf16, int kernel) {
#define SMEM_CASE(HD)                                                                       \
  case HD:                                                                                  \
    if (bf16 && HD <= 128) return kernel == 0 ? DkdvLayout<HD>::kSmem : DqLayout<HD>::kSmem; \
    return bf16 ? Bwd<__nv_bfloat16, HD>::kSmem : Bwd<float, HD>::kSmem;
  switch (hd) {
    SMEM_CASE(32)
    SMEM_CASE(64)
    SMEM_CASE(128)
    SMEM_CASE(256)
    default: return 0;
  }
#undef SMEM_CASE
}

}  // namespace

extern "C" {

// hd in {32, 64, 128, 256}; bf16 != 0 for bfloat16 tensors, else float32;
// window 0 means no window; 0 <= kv_len <= Sk; BH, Sq, Sk > 0. Every tensor
// starts on a 16-byte boundary (a tensor map's requirement; the float32
// tiles load 16 bytes a thread). dvec is a float32 scratch of 2 BH
// ceil(Sq / 64) 64 values (the wgmma path's row tiles; the other paths use
// its first BH Sq). Returns 0, a cudaError_t, or a negative code of the
// tensor-map encoder.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                        const void* dout, const void* lse, void* dvec, void* dq, void* dk,
                        void* dv, int BH, int Sq, int Sk, int hd, int group, int causal,
                        int window, int kv_len, int bf16, float sm_scale, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The paths are an explicit choice: bf16 at hd <= 128 on wgmma, bf16 at
  // hd 256 on mma.sync (its accumulators do not fit a warpgroup's
  // registers), float32 on FMAs.
#define BWD_ARGS q, k, v, out, dout, lse, dvec, dq, dk, dv, BH, Sq, Sk, group, causal, window, \
                 kv_len, sm_scale, device, s
#define BWD_CASE(HD)                                                                         \
  case HD:                                                                                   \
    return bf16 ? launch_bwd_wgmma<HD>(BWD_ARGS) : launch_bwd<float, HD>(BWD_ARGS);
  switch (hd) {
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    case 256:
      return bf16 ? launch_bwd<__nv_bfloat16, 256>(BWD_ARGS) : launch_bwd<float, 256>(BWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_CASE
#undef BWD_ARGS
}

// The dynamic shared memory the kernel of a call opts in to (kernel 0: dK/dV,
// 1: dQ), in bytes; 0 for a head dim the entry point does not take.
int flash_attention_bwd_smem(int hd, int bf16, int kernel) {
  return static_cast<int>(smem_of(hd, bf16 != 0, kernel));
}

}  // extern "C"
