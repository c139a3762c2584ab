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
//   lse (BH, Sq) float32       optional (null: not written): the natural
//                              log-sum-exp of each query row's scaled,
//                              masked scores, m + log(l), which the backward
//                              (flash_attention_bwd.cu) recomputes P from
//
// Arithmetic, as the TPU kernel: scores are float32 dot products of the
// inputs times hd^-0.5, masked to the finite -1e30 (never -inf, so a row
// whose first key block is all masked gives exp(0) terms that the first
// real block's correction exp(-1e30 - m) erases exactly); p = exp(s - m) is
// summed unrounded into l and rounded to the input dtype before the AV
// product; out = acc / max(l, 1e-30), cast to the input dtype. A query row
// with no unmasked key at all is undefined (the TPU kernel averages its
// padded keys there); the model never makes one. Key blocks wholly outside
// the causal or window band are skipped, which changes no value (the TPU
// kernel's visits there add exact zeros), and masks are applied only on
// blocks that cross a band edge or the ragged kv_len edge. Ragged Sq and Sk
// are handled in the kernel; nothing is padded.
//
// Bound: operations. At B=4, S=3072, H=16, KV=1, hd=256, window 2048,
// causal, the unmasked pairs need 2.75e11 FLOP (0.278 ms at 989 TFLOP/s
// bf16) against 214 MB of bytes (0.064 ms at 3.35 TB/s).
//
// Two paths, chosen by dtype:
//
// bf16 (the serving path): tensor cores. One block of two warpgroups per
// (query head row, 128 queries); each warpgroup owns 64 query rows. Q is
// loaded once by TMA; K and V tiles of 64 keys stream through a 2-stage
// ring in shared memory, each stage filled by TMA (cp.async.bulk.tensor
// with a 3-D tensor map, completion on an mbarrier) while the previous
// stage is computed. S = Q K^T is wgmma m64n64k16 with both operands in
// 128-byte-swizzled shared memory (K-major); the online-softmax update runs
// on S in registers (exp2 with hd^-0.5 * log2 e folded into the scale);
// p is rounded to bf16 into the register A fragment of O += P V, whose B
// operand is the V tile itself read MN-major (no transposed copy). O is a
// 64 x hd float32 accumulator in registers (128 a thread at hd=256); with
// no producer warpgroup both warpgroups keep the full 255-register budget
// of one 256-thread block an SM, so setmaxnreg is not needed. Shared
// memory: 1 KB alignment slack + Q 64 KB + 2 stages x (K + V) 128 KB at
// hd=256 (197,656 bytes). Head dims below 64 are staged 64 wide.
//
// float32 (off the serving path; the models compute in bf16): plain FMAs.
// One block per (query head row, 64 queries), 256 threads as 16 x 16, each
// with a 4 x 4 register tile of scores and a 4 x hd/16 accumulator tile; Q,
// K, V tiles staged synchronously in padded shared memory (210 KB at
// hd=256).
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() (or the error of the
// shared-memory opt-in, made once per device at the first launch, or of the
// tensor-map encoder).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {


constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;     // 16 x 16
constexpr int kRows = 4;          // query rows per thread: kBlockQ / 16
constexpr int kCols = 4;          // key columns per thread: kBlockK / 16
constexpr float kNegInf = -1e30f;

// Row stride (elements) of the Q and K tiles: one extra 32-bit word a row.
template <int HD>
__host__ __device__ constexpr int qk_stride() { return HD + 1; }
constexpr int kPStride = kBlockK + 1;   // float P tile

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBlockQ + kBlockK) * qk_stride<HD>() +
                      static_cast<size_t>(kBlockK) * HD) +
         sizeof(float) * (static_cast<size_t>(kBlockQ) * kPStride + 3 * kBlockQ);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, int group, int causal, int window, int kv_len, float sm_scale) {
  constexpr int QS = qk_stride<HD>();
  constexpr int TC = HD / 16;           // accumulator columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBlockQ * QS;
  float* Vs = Ks + kBlockK * QS;
  float* Ps = reinterpret_cast<float*>(Vs + kBlockK * HD);
  float* m_s = Ps + kBlockQ * kPStride;  // running max of each row
  float* l_s = m_s + kBlockQ;            // running sum of each row
  float* c_s = l_s + kBlockQ;            // this key block's correction

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const float* qp = q + static_cast<size_t>(bh) * Sq * HD;
  const float* kp = k + static_cast<size_t>(bh / group) * Sk * HD;
  const float* vp = v + static_cast<size_t>(bh / group) * Sk * HD;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    Qs[r * QS + c] = (q0 + r < Sq) ? qp[static_cast<size_t>(q0 + r) * HD + c] : 0.f;
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
      Ks[r * QS + c] = ok ? kp[g] : 0.f;
      Vs[r * HD + c] = ok ? vp[g] : 0.f;
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
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * QS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
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
        Ps[r * kPStride + tx + 16 * j] = p;
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
        const float vv = Vs[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

  float* op = out + static_cast<size_t>(bh) * Sq * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < TC; ++c)
      op[static_cast<size_t>(q0 + r) * HD + tx + 16 * c] = acc[i][c] / den;
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * Sq + q0 + r] = m_s[r] + logf(l_s[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA (wgmma) on tensor cores, K/V through a TMA ring.
// ---------------------------------------------------------------------------
constexpr int kWgBlockQ = 128;   // query rows a block: two consumer warpgroups of 64
constexpr int kWgBlockK = 64;    // keys a stage
constexpr int kWgStages = 2;     // K/V ring depth
constexpr int kWgThreads = 256;
constexpr int kSwizzleBytes = 128;  // one swizzled row: 64 bf16
constexpr int kSwizzleCols = 64;

// Head dims narrower than one swizzle row are staged 64 wide: the TMA
// box zero-fills the columns past hd, which S = Q K^T never reads (its k
// loop stops at hd) and O stores never write.
template <int HD>
__host__ __device__ constexpr int padded_hd() { return HD < kSwizzleCols ? kSwizzleCols : HD; }

template <int HD>
struct WgLayout {
  static constexpr int kColBlocks = padded_hd<HD>() / kSwizzleCols;
  static constexpr uint32_t kQBlock = kWgBlockQ * kSwizzleBytes;    // one 64-column block of Q
  static constexpr uint32_t kKvBlock = kWgBlockK * kSwizzleBytes;   // of K or V
  static constexpr uint32_t kQBytes = kColBlocks * kQBlock;
  static constexpr uint32_t kKvBytes = kColBlocks * kKvBlock;       // one K (or V) tile
  static constexpr uint32_t kStageBytes = 2 * kKvBytes;             // K then V
  static constexpr uint32_t kBarOffset = kQBytes + kWgStages * kStageBytes;
  // 1024 bytes of slack to align the base to the 128-byte swizzle's
  // 1024-byte atom, then the tiles, then 1 + kWgStages mbarriers.
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (1 + kWgStages);
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Start the TMA loads of key block `i` of a block's loop (keys k0..k0+63
// of KV row kvh) into its ring stage, against that stage's mbarrier.
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                        uint32_t base, int k0, int kvh, int i) {
  using L = WgLayout<HD>;
  const int st = i % kWgStages;
  const uint32_t s_k = base + L::kQBytes + st * L::kStageBytes;
  const uint32_t bar = base + L::kBarOffset + 8 * (1 + st);
  mbar_expect_tx(bar, L::kStageBytes);
  for (int b = 0; b < L::kColBlocks; ++b) {
    tma_load_3d(s_k + b * L::kKvBlock, tm_k, bar, b * kSwizzleCols, k0, kvh);
    tma_load_3d(s_k + L::kKvBytes + b * L::kKvBlock, tm_v, bar, b * kSwizzleCols, k0, kvh);
  }
}

// Accumulator fragment of m64nN (per warpgroup thread t, warp w = t / 32,
// lane l): element j of an n64 tile sits at row 16 w + l / 4 + 8 * ((j / 2) % 2)
// and column 8 (j / 4) + 2 (l % 4) + j % 2. Each thread holds two rows; the
// four lanes of a quad hold a row's 64 columns between them.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int Sq, int kv_len, int group, int causal, int window,
                   float scale_log2) {
  using L = WgLayout<HD>;
  constexpr int NB = L::kColBlocks;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t bar_q = base + L::kBarOffset;
  const uint32_t bar_full = bar_q + 8;  // + 8 * stage

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int kvh = bh / group;
  // Heaviest query blocks (most keys in the band) first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBlockQ;

  // Key blocks the whole block needs (the band of its 128 rows).
  const int q_last = min(q0 + kWgBlockQ, Sq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kb_begin = k_begin / kWgBlockK;
  const int n_kb = k_end > k_begin ? (k_end + kWgBlockK - 1) / kWgBlockK - kb_begin : 0;

  // This warpgroup's 64 rows and their band.
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 64, Sq) - 1;
  int wk_end = wq0 < Sq ? kv_len : 0;
  if (causal) wk_end = min(wk_end, wq_last + 1);
  const int wk_begin = window > 0 ? max(0, wq0 - window + 1) : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kWgStages; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
    for (int b = 0; b < NB; ++b)
      tma_load_3d(s_q + b * L::kQBlock, &tm_q, bar_q, b * kSwizzleCols, q0, bh);
    if (n_kb > 0) load_kv<HD>(&tm_k, &tm_v, base, kb_begin * kWgBlockK, kvh, 0);
  }

  float o[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this thread's share of each row's sum
  const int row0 = wq0 + 16 * warp + lane / 4;  // and row0 + 8
  const int col_lane = 2 * (lane % 4);
  const uint32_t s_q_wg = s_q + wg * 64 * kSwizzleBytes;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_kb; ++i) {
    // The stage block i + 1 lands in was last read in iteration i - 1,
    // which every thread finished before the barrier that closed it.
    if (tid == 0 && i + 1 < n_kb)
      load_kv<HD>(&tm_k, &tm_v, base, (kb_begin + i + 1) * kWgBlockK, kvh, i + 1);
    const int st = i % kWgStages;
    const uint32_t s_k = base + L::kQBytes + st * L::kStageBytes;
    const uint32_t s_v = s_k + L::kKvBytes;
    mbar_wait(bar_full + 8 * st, (i / kWgStages) & 1);
    const int k0 = (kb_begin + i) * kWgBlockK;

    if (k0 < wk_end && k0 + kWgBlockK > wk_begin) {
      // S = Q K^T over hd in k-steps of 16: a step moves 32 bytes along
      // a swizzled row, a 64-column block moves a whole block.
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = sw128_desc(s_q_wg + (kk / 4) * L::kQBlock + off, 0, 1024);
        const uint64_t db = sw128_desc(s_k + (kk / 4) * L::kKvBlock + off, 0, 1024);
        wgmma_ss_64x64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Scale into the log2 domain and mask where the block crosses the
      // band's or the ragged edge (-1e30, finite, as the TPU kernel).
      const bool edge = (k0 + kWgBlockK > kv_len) || (causal && k0 + kWgBlockK - 1 > wq0) ||
                        (window > 0 && wq_last - k0 >= window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s[j] *= scale_log2;
        if (edge) {
          const int q_pos = row0 + 8 * ((j / 2) % 2);
          const int k_pos = k0 + 8 * (j / 4) + col_lane + j % 2;
          bool ok = k_pos < kv_len;
          if (causal) ok = ok && k_pos <= q_pos;
          if (window > 0) ok = ok && (q_pos - k_pos) < window;
          if (!ok) s[j] = kNegInf;
        }
      }
      // Online softmax: row max over the quad, correction, p = 2^(s - m).
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * h], s[4 * c + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_row[h], mx);
        corr[h] = exp2f(m_row[h] - m_new);
        m_row[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[4 * c + 2 * h + e] - m_new);
            s[4 * c + 2 * h + e] = p;
            sum += p;
          }
        }
        l_row[h] = l_row[h] * corr[h] + sum;
      }
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[c][j] *= corr[(j / 2) % 2];

      // p rounded to bf16: the accumulator layout of S columns 16 kk..+15
      // is the register A fragment of the k-step kk of P V.
      uint32_t pa[kWgBlockK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgBlockK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // O += P V: V is the MN-major B operand straight from its tile (16
      // keys a step = 2048 bytes; 64 output columns a column block). With
      // one 64-column block per instruction the leading byte offset (the
      // stride between column blocks) is never used.
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBlockK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NB; ++c)
          wgmma_rs_64x64(o[c], pa[kk],
                         sw128_desc(s_v + c * L::kKvBlock + kk * 2048, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(o[c]);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }

  // out = acc / max(l, 1e-30), l summed over the quad; the log-sum-exp
  // in natural units from the log2-domain max (first lane of the quad).
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[h] = fmaxf(l, 1e-30f);
    const int row = row0 + 8 * h;
    if (lse != nullptr && (lane & 3) == 0 && row < Sq)
      lse[static_cast<size_t>(bh) * Sq + row] = (m_row[h] + log2f(l)) * 0.6931471805599453f;
  }
  __nv_bfloat16* op = out + static_cast<size_t>(bh) * Sq * HD;
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
        *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(row) * HD + col) =
            __floats2bfloat162_rn(o[c][4 * cc + 2 * h] / den[h],
                                  o[c][4 * cc + 2 * h + 1] / den[h]);
      }
    }
  }
}

// Opt a kernel in to its dynamic shared memory once per device, so a
// launch inside CUDA-graph capture makes no attribute call.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, int device, bool (&done)[kMaxDevices]) {
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) done[device] = true;
  return err;
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int Sq,
               int Sk,
               int group, int causal, int window, int kv_len, float sm_scale, int device,
               cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  constexpr size_t smem = f32_smem_bytes<HD>();
  const cudaError_t err = opt_in_smem(flash_f32_kernel<HD>, smem, device, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, ceil_div(Sq, kBlockQ));
  flash_f32_kernel<HD><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), Sq, Sk, group, causal, window, kv_len,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
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
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int BH, int Sq,
                int Sk,
                int group, int causal, int window, int kv_len, float sm_scale, int device,
                cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  constexpr size_t smem = WgLayout<HD>::kSmem;
  const cudaError_t err = opt_in_smem(flash_wgmma_kernel<HD>, smem, device, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = make_map(&tm_q, q, HD, Sq, BH, kWgBlockQ);
  if (rc == 0) rc = make_map(&tm_k, k, HD, Sk, BH / group, kWgBlockK);
  if (rc == 0) rc = make_map(&tm_v, v, HD, Sk, BH / group, kWgBlockK);
  if (rc != 0) return rc;
  const dim3 grid(BH, ceil_div(Sq, kWgBlockQ));
  flash_wgmma_kernel<HD><<<grid, kWgThreads, smem, s>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, kv_len,
      group, causal, window, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// The two paths are an explicit choice by dtype: bf16 (the served models)
// on the tensor cores, float32 on the FMA kernel.
int dispatch_hd(bool bf16, int hd, const void* q, const void* k, const void* v, void* out,
                void* lse, int BH, int Sq, int Sk, int group, int causal, int window, int kv_len,
                float sm_scale, int device, cudaStream_t s) {
#define FLASH_CASE(HD)                                                                      \
  case HD:                                                                                  \
    return bf16 ? launch_bf16<HD>(q, k, v, out, lse, BH, Sq, Sk, group, causal, window,     \
                                  kv_len, sm_scale, device, s)                              \
                : launch_f32<HD>(q, k, v, out, lse, BH, Sq, Sk, group, causal, window,      \
                                 kv_len, sm_scale, device, s);
  switch (hd) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

// hd in {32, 64, 128, 256}; bf16 != 0 for bfloat16 tensors, else float32.
// window 0 means no window; 0 <= kv_len <= Sk. bf16 tensors must start on
// a 16-byte boundary (a tensor map's requirement). lse is null (serving)
// or a float32 (BH, Sq) tensor for the log-sum-exp rows. Returns 0, a
// cudaError_t, or a negative code of the tensor-map encoder.
int flash_attention(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                    int Sq, int Sk, int hd, int group, int causal, int window, int kv_len,
                    int bf16, float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch_hd(bf16 != 0, hd, q, k, v, out, lse, BH, Sq, Sk, group, causal, window,
                     kv_len, sm_scale, device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
