// Hand-written Hopper (sm_90a) kernels for the NOMA pairwise-interference
// reduction of paper eqs. (5)/(8), the planner's hot spot: every Li-GD
// iteration evaluates them forward and backward on both links.
//
// Three kernels, each with a plain C entry point (bound with ctypes by
// kernels/build.py; the wrappers and plain PyTorch twins are in
// kernels/noma_rates.py). Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
//
// Fleets. The dense intra, per_ap and contract kernels take a leading member
// dimension B (the JAX package runs them under jax.vmap, which adds a grid
// axis): member b is grid z = b, and every operand of member b sits at b
// times its member stride. A launch's geometry (chunks a cell, split,
// w ranges, tiles) depends on (U, N, M) alone, never on B, so member b of
// a fleet launch sums the same terms in the same order as a launch on b
// alone: the same bits. A single environment is the B = 1 launch. B is at
// most 65,535 (grid z). The dense intra kernel offsets its operands by
// size_t member strides; per_ap and contract fold the member into their
// row indices instead (gain()), B * W and B * N being ints, and every
// element index is size_t.
//
// 1. cell_intra   replaces src/repro/kernels/noma_rates.py
//                 noma_cell_intra_kernel (_cell_intra_kernel):
//      out[r,m] = sum_s [ap_r[r]==ap_s[s]] * cmp(own_s[s,m], own_r[r,m]) * w_s[s,m]
//    cmp is '<' (descending, uplink SIC) or '>' (downlink SIC). Two entry
//    points compute it:
//    - noma_cell_intra_dense, the dense schedule the planner runs (no
//      CellLayout; forward and backward, roles swapped in the backward).
//    - noma_cell_intra, over a CSR list of (receiver block, streamed block)
//      tiles: a CellLayout's same-cell block-diagonal tiles (or, for
//      comparison, the dense list of all U^2 tiles).
//    Bound: operations. The work a run's data needs is one compare, select
//    and add per same-cell (r, s, m) triple: 3.2e7 at U=1250, N=16, M=250
//    (0.00286 ms at 33.5e12 non-FMA instructions a second), far above the
//    ~5 MB it reads. The dense tile list visits all U^2*M = 3.9e8 triples,
//    12x what the data needs.
//    Dense design: work per cell, not per U^2. One thread block per
//    (32-wide m block, cell, receiver-chunk slot); it finds its cell's
//    receivers and senders itself, in ascending id, by a block-wide
//    ballot/prefix compaction of the AP ids in shared memory (2048 ids a
//    pass, 8 KB), so it needs no host sync, no extra launch and no tile
//    list. Only same-cell senders are streamed: their own_s / w_s rows are
//    gathered by index (coalesced along m) into a double-buffered cp.async
//    ring of 32-sender tiles read by all 8 warps; each thread keeps 4
//    receivers in registers, so one shared-memory read feeds 4 triples.
//    Skewed cells (19 to 203 users) spread over several blocks: a cell gets
//    enough 32-receiver chunk slots for a cell 3x the mean size, and a
//    larger cell's slots take several chunks in turn. Every receiver sums
//    its senders in ascending id: no atomics, the same order on every run.
//    CSR design: one thread block owns one (receiver block, 32-wide
//    m block) output tile and walks its receiver block's CSR run in order
//    (the TPU kernel instead revisits a VMEM accumulator across sequential
//    grid steps). Each streamed tile (own_s, w_s, ap_s) is staged once in
//    shared memory and read by all 8 warps; each thread keeps ROWS
//    receivers in registers. Ragged edges are masked with selects (ap
//    sentinel -1 for rows past S), never with a multiply.
//
// 2. per_ap       replaces noma_rates.py noma_per_ap_kernel (_per_ap_kernel):
//      out[n,m] = sum_w [ap[w] != n] * wgt[w,m] * g
//    with g = g[w,n,m] (uplink layout) or g[n,w,m] (downlink layout).
//    Bound: bytes (the raw gain, W*N*M floats, read once: 20 MB at W=1250,
//    N=16, M=250, 6.35 us at 3.35 TB/s). Covering HBM's latency at that
//    rate takes about 2 MB of loads in flight across the card.
//    Design: the w reduction is split across the blocks of a thread-block
//    cluster (split <= 8 blocks, the portable cluster size). One cluster
//    per output tile of (kPerApGroup = 2 APs, 32-wide m block), the tiles
//    along grid x (any count up to 2^31 - 1) and the cluster along grid y;
//    cluster rank r takes the contiguous w range
//    [r * w_chunk, min(W, (r + 1) * w_chunk)). Inside a block the 8 warps
//    interleave over that range (w = lo + warp, lo + warp + 8, ...), each
//    thread issuing the loads of kPerApUnroll w's (one wgt value and
//    kPerApGroup gains each) before it adds any of them: 512 blocks of 8
//    warps at the planner's shape, about 6 MB of loads in flight. One wgt
//    value feeds kPerApGroup APs, so wgt is read N / 2 times (through L2),
//    not N times. Distributed shared memory may be touched only once every
//    block of the cluster has started: each thread arrives (relaxed) at a
//    first cluster barrier on entry and waits on it after its w loop, so
//    the loop hides the wait. Then each rank writes its partial tile into
//    rank 0's shared memory (map_shared_rank) and arrives at a second
//    cluster barrier with release semantics; only rank 0 waits (acquire),
//    adds the tiles in rank order and stores, and the other ranks exit at
//    once (nothing reads their shared memory). One launch, no atomics, no
//    scratch in global memory.
//    Alignment: at M = 250 a gain row is 1,000 bytes, not a multiple of 16,
//    so neither float4 loads nor a TMA tensor map over g are legal; every
//    load is a coalesced 4-byte load along m (a warp reads 128 bytes).
//    Determinism: every output element is ((p_0 + p_1) + ...) + p_{split-1},
//    p_r rank r's 8 warp sums added in warp order, each warp's sum taken in
//    ascending w. split and w_chunk come from the shapes alone
//    (kernels/noma_rates.py per_ap_geometry), so two launches on the same
//    inputs give the same bits.
//
// 3. ap_contract  replaces noma_rates.py noma_ap_contract_kernel
//                 (_ap_contract_kernel):
//      out[w,m] = sum_n [ap[w] != n] * g * nm[n,m]
//    Bound: bytes (the raw gain read once).
//    Design: one thread per (w, m), threads along m, looping over n < N:
//    APs past N are never visited, the CUDA form of the TPU kernel's
//    explicit out-of-range n mask. Each thread issues the loads of
//    kContractUnroll APs before it adds their terms in ascending n (left to
//    the compiler, the loop kept fewer loads in flight once the fleet
//    member entered the indices, and ran slower).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 32;  // m per thread block: one warp wide
constexpr int kWarps = 8;   // warps per thread block

template <int ROWS, bool DESC>
__global__ void __launch_bounds__(kLanes * kWarps)
cell_intra_kernel(const float* __restrict__ own_r, const float* __restrict__ own_s,
                  const float* __restrict__ w_s, const int* __restrict__ ap_r,
                  const int* __restrict__ ap_s, const int* __restrict__ row_ptr,
                  const int* __restrict__ col, float* __restrict__ out, int R,
                  int S, int M, int block_r, int block_s) {
  extern __shared__ float smem[];
  float* sh_own = smem;                         // [block_s][kLanes]
  float* sh_w = smem + block_s * kLanes;        // [block_s][kLanes]
  int* sh_ap = reinterpret_cast<int*>(sh_w + block_s * kLanes);  // [block_s]

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int rb = blockIdx.x;
  const int m0 = blockIdx.y * kLanes;
  const int m = m0 + lane;
  const bool m_ok = m < M;

  float own_mine[ROWS];
  int ap_mine[ROWS];
  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int rl = warp * ROWS + i;
    const int r = rb * block_r + rl;
    const bool r_ok = rl < block_r && r < R;
    own_mine[i] = (r_ok && m_ok) ? own_r[static_cast<size_t>(r) * M + m] : 0.f;
    ap_mine[i] = r_ok ? ap_r[r] : -2;  // never equals a streamed id or -1
    acc[i] = 0.f;
  }

  const int t_end = row_ptr[rb + 1];
  for (int t = row_ptr[rb]; t < t_end; ++t) {
    const int s0 = col[t] * block_s;
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < block_s * kLanes; idx += kLanes * kWarps) {
      const int s = s0 + idx / kLanes;
      const int mm = m0 + idx % kLanes;
      const bool ok = s < S && mm < M;
      sh_own[idx] = ok ? own_s[static_cast<size_t>(s) * M + mm] : 0.f;
      sh_w[idx] = ok ? w_s[static_cast<size_t>(s) * M + mm] : 0.f;
    }
    for (int sl = tid; sl < block_s; sl += kLanes * kWarps) {
      const int s = s0 + sl;
      sh_ap[sl] = s < S ? ap_s[s] : -1;
    }
    __syncthreads();
    for (int sl = 0; sl < block_s; ++sl) {
      const float o = sh_own[sl * kLanes + lane];
      const float w = sh_w[sl * kLanes + lane];
      const int a = sh_ap[sl];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const bool cmp = DESC ? (o < own_mine[i]) : (o > own_mine[i]);
        acc[i] += (cmp && a == ap_mine[i]) ? w : 0.f;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int rl = warp * ROWS + i;
    const int r = rb * block_r + rl;
    if (rl < block_r && r < R && m_ok) out[static_cast<size_t>(r) * M + m] = acc[i];
  }
}

// -- cell_intra on the dense schedule: per-cell work -------------------------
constexpr int kDenseRows = 4;                       // receivers a thread
constexpr int kDenseChunk = kWarps * kDenseRows;    // receivers a block
constexpr int kDenseTile = 32;                      // senders a streamed tile
constexpr int kDenseBallots = 8;                    // ballots a warp per window
constexpr int kDenseWindow = kWarps * kDenseBallots * kLanes;  // ids a compaction pass

// Block-wide, order-keeping compaction of the users of `cell` among ids
// [base, base + kDenseWindow) of ap (n ids in all): warp w scans
// kDenseBallots x 32 consecutive ids, warps are ranked by a prefix of
// their counts. Each hit is handed to emit(id, rank within the window).
// Returns the window's count. All threads of the block must call it.
template <typename Emit>
__device__ __forceinline__ int compact_window(const int* __restrict__ ap, int n, int cell,
                                              int base, int* warp_cnt, Emit emit) {
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int w0 = base + warp * kDenseBallots * kLanes;
  // All loads first, so their latencies overlap (a ballot waits for its
  // operand); ids past n read as -1, which is no cell.
  int ids[kDenseBallots];
#pragma unroll
  for (int b = 0; b < kDenseBallots; ++b) {
    const int id = w0 + b * kLanes + lane;
    ids[b] = id < n ? ap[id] : -1;
  }
  unsigned mask[kDenseBallots];
  int cnt = 0;
#pragma unroll
  for (int b = 0; b < kDenseBallots; ++b) {
    mask[b] = __ballot_sync(0xffffffffu, ids[b] == cell);
    cnt += __popc(mask[b]);
  }
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  int pos = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_cnt[w];
    pos += w < warp ? c : 0;
    total += c;
  }
#pragma unroll
  for (int b = 0; b < kDenseBallots; ++b) {
    if ((mask[b] >> lane) & 1u)
      emit(w0 + b * kLanes + lane, pos + __popc(mask[b] & ((1u << lane) - 1u)));
    pos += __popc(mask[b]);
  }
  __syncthreads();  // warp_cnt is reused, and the emitted lists are complete
  return total;
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread block per (32-wide m block, cell, receiver chunk slot). Chunk
// slot j takes the cell's receiver chunks j, j + chunks_per_cell, ... (a
// chunk is kDenseChunk receivers in ascending id); a slot past the cell's
// chunks exits after counting. Each thread keeps kDenseRows receivers of
// its warp in registers; the cell's senders, found window by window in
// ascending id, stream through a double-buffered cp.async ring of
// (kDenseTile senders x 32 m) tiles of own_s and w_s that all 8 warps read.
// Every receiver of the cell gets every same-cell sender in ascending id:
// the same order on every run, no atomics.
template <bool DESC>
__global__ void __launch_bounds__(kLanes * kWarps)
cell_intra_dense_kernel(const float* __restrict__ own_r, const float* __restrict__ own_s,
                        const float* __restrict__ w_s, const int* __restrict__ ap_r,
                        const int* __restrict__ ap_s, float* __restrict__ out, int R, int S,
                        int M, int n_aps, int chunks_per_cell) {
  // Member blockIdx.z of the fleet: its operands at their member strides.
  const size_t mem = blockIdx.z;
  own_r += mem * R * M;
  own_s += mem * S * M;
  w_s += mem * S * M;
  ap_r += mem * R;
  ap_s += mem * S;
  out += mem * R * M;
  __shared__ int recv[kDenseChunk];
  __shared__ int send[kDenseWindow];
  __shared__ int warp_cnt[kWarps];
  __shared__ float t_own[2][kDenseTile][kLanes];
  __shared__ float t_w[2][kDenseTile][kLanes];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  // Slot-major launch order: every cell's first chunk before any cell's
  // second, so the blocks that find no chunk to take come last.
  const int cell = blockIdx.y % n_aps;
  const int slot = blockIdx.y / n_aps;
  const int m0 = blockIdx.x * kLanes;
  const int m = m0 + lane;
  const bool m_ok = m < M;
  const int m_ld = min(m, M - 1);  // lanes past M load a valid address, store nothing

  for (int chunk = slot;; chunk += chunks_per_cell) {
    // This chunk's receivers: ranks [lo, lo + kDenseChunk) of the cell.
    const int lo = chunk * kDenseChunk;
    int n_cell = 0;
    for (int base = 0; base < R; base += kDenseWindow) {
      const int before = n_cell;
      n_cell += compact_window(ap_r, R, cell, base, warp_cnt, [&](int id, int rank) {
        const int k = before + rank - lo;
        if (k >= 0 && k < kDenseChunk) recv[k] = id;
      });
    }
    if (lo >= n_cell) return;  // block-uniform: every thread holds the same count
    const int n_recv = min(kDenseChunk, n_cell - lo);

    float own_mine[kDenseRows];
    float acc[kDenseRows];
#pragma unroll
    for (int i = 0; i < kDenseRows; ++i) {
      const int rl = warp * kDenseRows + i;
      own_mine[i] = rl < n_recv ? own_r[static_cast<size_t>(recv[rl]) * M + m_ld] : 0.f;
      acc[i] = 0.f;
    }
    const bool warp_live = warp * kDenseRows < n_recv;

    for (int base = 0; base < S; base += kDenseWindow) {
      const int n_send = compact_window(ap_s, S, cell, base, warp_cnt,
                                        [&](int id, int rank) { send[rank] = id; });
      const int n_tiles = (n_send + kDenseTile - 1) / kDenseTile;
      auto fetch = [&](int t) {
        const int buf = t & 1;
        for (int idx = tid; idx < kDenseTile * kLanes; idx += kLanes * kWarps) {
          const int sl = idx / kLanes, ml = idx % kLanes;
          const int k = t * kDenseTile + sl;
          if (k < n_send) {
            const size_t g = static_cast<size_t>(send[k]) * M + min(m0 + ml, M - 1);
            cp_async_f32(&t_own[buf][sl][ml], own_s + g);
            cp_async_f32(&t_w[buf][sl][ml], w_s + g);
          }
        }
        cp_async_commit();
      };
      if (n_tiles > 0) fetch(0);
      for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
          fetch(t + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (warp_live) {
          const int buf = t & 1;
          const int cnt = min(kDenseTile, n_send - t * kDenseTile);
#pragma unroll 4
          for (int sl = 0; sl < cnt; ++sl) {
            const float o = t_own[buf][sl][lane];
            const float w = t_w[buf][sl][lane];
#pragma unroll
            for (int i = 0; i < kDenseRows; ++i) {
              const bool cmp = DESC ? (o < own_mine[i]) : (o > own_mine[i]);
              acc[i] += cmp ? w : 0.f;
            }
          }
        }
        __syncthreads();  // the buffer is refilled by the fetch two tiles on
      }
    }

#pragma unroll
    for (int i = 0; i < kDenseRows; ++i) {
      const int rl = warp * kDenseRows + i;
      if (rl < n_recv && m_ok) out[static_cast<size_t>(recv[rl]) * M + m] = acc[i];
    }
    __syncthreads();  // recv is rewritten by the next chunk
  }
}

// The gain of fleet member b, (w, n, m): uplink layout (B, W, N, M),
// downlink (B, N, W, M). The member enters the index, not the base
// pointer, so the base stays a kernel parameter and the loops keep their
// registers for loads in flight (B * W and B * N fit an int: checked at
// launch).
template <bool UPLINK>
__device__ __forceinline__ float gain(const float* __restrict__ g, int b, int w, int n,
                                      int m, int W, int N, int M) {
  return UPLINK ? g[(static_cast<size_t>(b * W + w) * N + n) * M + m]
                : g[(static_cast<size_t>(b * N + n) * W + w) * M + m];
}

// -- per_ap: w split across the blocks of a cluster ---------------------------
constexpr int kPerApUnroll = 4;    // w's of loads a thread has in flight
constexpr int kPerApMaxSplit = 8;  // blocks of a cluster: the portable limit
constexpr int kPerApGroup = 2;     // APs a cluster: one wgt load feeds both

// Grid (ceil(N / kPerApGroup) * ceil(M / 32), split, B) in clusters of
// (1, split, 1): the cluster is one output tile, of kPerApGroup APs x 32 m,
// of fleet member z (APs past N load and store nothing), its rank r the w range
// [r * w_chunk, min(W, (r + 1) * w_chunk)).
template <bool UPLINK>
__global__ void __launch_bounds__(kLanes * kWarps)
per_ap_kernel(const int* __restrict__ ap, const float* __restrict__ wgt,
              const float* __restrict__ g, float* __restrict__ out, int W, int N, int M,
              int w_chunk) {
  const int b = blockIdx.z;  // fleet member; a cluster never spans two
  const int wb = b * W;      // member b's first row of ap and wgt
  __shared__ float part[kWarps][kPerApGroup][kLanes];
  __shared__ float gather[kPerApMaxSplit][kPerApGroup][kLanes];  // rank 0's: each rank's tile
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int m_blocks = (M + kLanes - 1) / kLanes;
  const int n0 = static_cast<int>(blockIdx.x) / m_blocks * kPerApGroup;
  const int m = static_cast<int>(blockIdx.x) % m_blocks * kLanes + lane;
  const int lo = rank * w_chunk;
  const int hi = min(W, lo + w_chunk);
  // Announce this block's start; the matching wait comes after the w loop.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[kPerApGroup];
#pragma unroll
  for (int j = 0; j < kPerApGroup; ++j) acc[j] = 0.f;
  if (m < M) {
    int w = lo + warp;
    // All loads of kPerApUnroll w's first, then their terms in ascending w.
    for (; w + (kPerApUnroll - 1) * kWarps < hi; w += kPerApUnroll * kWarps) {
      int a[kPerApUnroll];
      float x[kPerApUnroll];
      float gv[kPerApUnroll][kPerApGroup];
#pragma unroll
      for (int u = 0; u < kPerApUnroll; ++u) {
        const int wu = w + u * kWarps;
        a[u] = ap[wb + wu];
        x[u] = wgt[static_cast<size_t>(wb + wu) * M + m];
#pragma unroll
        for (int j = 0; j < kPerApGroup; ++j)
          gv[u][j] = n0 + j < N ? gain<UPLINK>(g, b, wu, n0 + j, m, W, N, M) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPerApUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kPerApGroup; ++j) {
          const float term = x[u] * gv[u][j];
          acc[j] += (a[u] != n0 + j) ? term : 0.f;
        }
    }
    for (; w < hi; w += kWarps) {
      const int a = ap[wb + w];
      const float x = wgt[static_cast<size_t>(wb + w) * M + m];
#pragma unroll
      for (int j = 0; j < kPerApGroup; ++j) {
        const float term = n0 + j < N ? x * gain<UPLINK>(g, b, w, n0 + j, m, W, N, M) : 0.f;
        acc[j] += (a != n0 + j) ? term : 0.f;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPerApGroup; ++j) part[warp][j][lane] = acc[j];
  __syncthreads();
  // Every block of the cluster has started: rank 0's shared memory exists.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kPerApGroup; ++j) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < kWarps; ++y) s += part[y][j][lane];
      *cluster.map_shared_rank(&gather[rank][j][lane], 0) = s;
    }
  }
  // Every rank's tile is in rank 0's shared memory once rank 0 has waited
  // at this second cluster barrier; the other ranks arrive (release) and exit, as
  // nothing reads their shared memory.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (warp == 0 && m < M) {
#pragma unroll
    for (int j = 0; j < kPerApGroup; ++j) {
      if (n0 + j >= N) continue;
      float s = gather[0][j][lane];
      for (int r = 1; r < split; ++r) s += gather[r][j][lane];
      out[static_cast<size_t>(b * N + n0 + j) * M + m] = s;
    }
  }
}

constexpr int kContractUnroll = 4;  // APs of loads a thread has in flight

template <bool UPLINK>
__global__ void __launch_bounds__(kLanes * kWarps)
ap_contract_kernel(const int* __restrict__ ap, const float* __restrict__ nm,
                   const float* __restrict__ g, float* __restrict__ out, int W, int N,
                   int M) {
  const int b = blockIdx.z;  // fleet member
  const int w = blockIdx.x * kWarps + threadIdx.y;
  const int m = blockIdx.y * kLanes + threadIdx.x;
  if (w >= W || m >= M) return;
  const int a = ap[b * W + w];
  float acc = 0.f;
  int n = 0;
  // The loads of kContractUnroll APs first, then their terms in ascending n.
  for (; n + kContractUnroll <= N; n += kContractUnroll) {
    float gv[kContractUnroll], tv[kContractUnroll];
#pragma unroll
    for (int u = 0; u < kContractUnroll; ++u) {
      gv[u] = gain<UPLINK>(g, b, w, n + u, m, W, N, M);
      tv[u] = nm[static_cast<size_t>(b * N + n + u) * M + m];
    }
#pragma unroll
    for (int u = 0; u < kContractUnroll; ++u) {
      const float term = gv[u] * tv[u];
      acc += (a != n + u) ? term : 0.f;
    }
  }
  for (; n < N; ++n) {
    const float term =
        gain<UPLINK>(g, b, w, n, m, W, N, M) * nm[static_cast<size_t>(b * N + n) * M + m];
    acc += (a != n) ? term : 0.f;
  }
  out[static_cast<size_t>(b * W + w) * M + m] = acc;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

constexpr int kMaxMembers = 65535;  // fleet members: grid z
constexpr int kMaxGridY = 65535;

// per_ap and contract index rows of the fleet by int (gain()).
bool member_rows_fit(int B, int W, int N) {
  return static_cast<long long>(B) * W <= 0x7fffffff && static_cast<long long>(B) * N <= 0x7fffffff;
}

template <int ROWS>
void launch_intra(bool desc, dim3 grid, size_t smem, cudaStream_t stream,
                  const float* own_r, const float* own_s, const float* w_s,
                  const int* ap_r, const int* ap_s, const int* row_ptr, const int* col,
                  float* out, int R, int S, int M, int block_r, int block_s) {
  const dim3 block(kLanes, kWarps);
  if (desc) {
    cell_intra_kernel<ROWS, true><<<grid, block, smem, stream>>>(
        own_r, own_s, w_s, ap_r, ap_s, row_ptr, col, out, R, S, M, block_r, block_s);
  } else {
    cell_intra_kernel<ROWS, false><<<grid, block, smem, stream>>>(
        own_r, own_s, w_s, ap_r, ap_s, row_ptr, col, out, R, S, M, block_r, block_s);
  }
}

}  // namespace

extern "C" {

// block_r <= kWarps * 8 = 64 rows; rows_per_thread is ceil(block_r / kWarps)
// rounded up to 1, 2, 4 or 8 by the caller. Dynamic shared memory:
// block_s * (2 * kLanes * 4 + 4) bytes.
int noma_cell_intra(const float* own_r, const float* own_s, const float* w_s,
                    const int* ap_r, const int* ap_s, const int* row_ptr, const int* col,
                    float* out, int R, int S, int M, int block_r, int block_s,
                    int rows_per_thread, int descending, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(R, block_r), ceil_div(M, kLanes));
  const size_t smem = static_cast<size_t>(block_s) * (2 * kLanes * sizeof(float) + sizeof(int));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool desc = descending != 0;
  switch (rows_per_thread) {
    case 1: launch_intra<1>(desc, grid, smem, s, own_r, own_s, w_s, ap_r, ap_s, row_ptr, col, out, R, S, M, block_r, block_s); break;
    case 2: launch_intra<2>(desc, grid, smem, s, own_r, own_s, w_s, ap_r, ap_s, row_ptr, col, out, R, S, M, block_r, block_s); break;
    case 4: launch_intra<4>(desc, grid, smem, s, own_r, own_s, w_s, ap_r, ap_s, row_ptr, col, out, R, S, M, block_r, block_s); break;
    case 8: launch_intra<8>(desc, grid, smem, s, own_r, own_s, w_s, ap_r, ap_s, row_ptr, col, out, R, S, M, block_r, block_s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dense schedule (no CellLayout): every receiver against every sender
// of its cell, for each of B fleet members. AP ids must lie in [0, n_aps);
// grid (ceil(M / 32), n_aps * chunks_per_cell, B) of 8 x 32 threads, 24,736
// bytes of static shared memory.
int noma_cell_intra_dense(const float* own_r, const float* own_s, const float* w_s,
                          const int* ap_r, const int* ap_s, float* out, int B, int R, int S,
                          int M, int n_aps, int chunks_per_cell, int descending, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_aps < 1 || chunks_per_cell < 1 || B < 1 || B > kMaxMembers ||
      static_cast<long long>(n_aps) * chunks_per_cell > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ceil_div(M, kLanes), n_aps * chunks_per_cell, B);
  const dim3 block(kLanes, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (descending) {
    cell_intra_dense_kernel<true><<<grid, block, 0, s>>>(own_r, own_s, w_s, ap_r, ap_s, out,
                                                         R, S, M, n_aps, chunks_per_cell);
  } else {
    cell_intra_dense_kernel<false><<<grid, block, 0, s>>>(own_r, own_s, w_s, ap_r, ap_s, out,
                                                          R, S, M, n_aps, chunks_per_cell);
  }
  return static_cast<int>(cudaGetLastError());
}

// split blocks a cluster (1..8), each a range of w_chunk w's covering
// [0, W) (split * w_chunk >= W). Grid (ceil(N / 2) * ceil(M / 32), split, B)
// of 8 x 32 threads, launched with cudaLaunchKernelEx and a cluster
// dimension of (1, split, 1).
int noma_per_ap(const int* ap, const float* wgt, const float* g, float* out, int B, int W,
                int N, int M, int split, int w_chunk, int uplink, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(ceil_div(N, kPerApGroup)) * ceil_div(M, kLanes);
  if (split < 1 || split > kPerApMaxSplit || w_chunk < 1 ||
      static_cast<long long>(split) * w_chunk < W || tiles > 0x7fffffff || B < 1 ||
      B > kMaxMembers || !member_rows_fit(B, W, N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), split, B);
  cfg.blockDim = dim3(kLanes, kWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = uplink ? cudaLaunchKernelEx(&cfg, per_ap_kernel<true>, ap, wgt, g, out, W, N, M, w_chunk)
               : cudaLaunchKernelEx(&cfg, per_ap_kernel<false>, ap, wgt, g, out, W, N, M, w_chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Grid (ceil(W / 8), ceil(M / 32), B) of 8 x 32 threads.
int noma_ap_contract(const int* ap, const float* nm, const float* g, float* out, int B,
                     int W, int N, int M, int uplink, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || B > kMaxMembers || ceil_div(M, kLanes) > kMaxGridY ||
      !member_rows_fit(B, W, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ceil_div(W, kWarps), ceil_div(M, kLanes), B);
  const dim3 block(kLanes, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uplink) {
    ap_contract_kernel<true><<<grid, block, 0, s>>>(ap, nm, g, out, W, N, M);
  } else {
    ap_contract_kernel<false><<<grid, block, 0, s>>>(ap, nm, g, out, W, N, M);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
