// Hand-written Hopper (sm_90a) kernels for the NOMA pairwise-interference
// reduction of paper eqs. (5)/(8), the planner's hot spot: every Li-GD
// iteration evaluates them forward and backward on both links.
//
// Three kernels, each with a plain C entry point (bound with ctypes by
// kernels/build.py; the wrappers and plain PyTorch twins are in
// kernels/noma_rates.py). Every entry point launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
//
// 1. cell_intra   replaces src/repro/kernels/noma_rates.py
//                 noma_cell_intra_kernel (_cell_intra_kernel):
//      out[r,m] = sum_s [ap_r[r]==ap_s[s]] * cmp(own_s[s,m], own_r[r,m]) * w_s[s,m]
//    over a CSR list of (receiver block, streamed block) tiles; cmp is '<'
//    (descending, uplink SIC) or '>' (downlink SIC).
//    Bound: operations. The work a run's data needs is one compare and one
//    add per same-cell (r, s, m) triple; the dense schedule visits all U^2*M
//    triples (3.9e8 at U=1250, M=250), far above the ~5 MB it reads.
//    Design: one thread block owns one (receiver block, 32-wide m block)
//    output tile and walks its receiver block's CSR run in order, so the sum
//    needs no atomics and is the same on every run (the TPU kernel instead
//    revisits a VMEM accumulator across sequential grid steps). Threads lie
//    along m, so global loads of the row-major (U, M) operands coalesce;
//    each streamed tile (own_s, w_s, ap_s) is staged once in shared memory
//    and read by all 8 warps, and each thread keeps ROWS receivers in
//    registers so one shared-memory read feeds ROWS triples. Ragged edges
//    are masked with selects (ap sentinel -1 for rows past S), never with a
//    multiply.
//
// 2. per_ap       replaces noma_rates.py noma_per_ap_kernel (_per_ap_kernel):
//      out[n,m] = sum_w [ap[w] != n] * wgt[w,m] * g
//    with g = g[w,n,m] (uplink layout) or g[n,w,m] (downlink layout).
//    Bound: bytes (the raw gain, W*N*M floats, read once).
//    Design: one thread block per (n, 32-wide m block); its 8 warps split
//    the w loop (w = warp, warp+8, ...) and their partial sums are added in
//    a fixed order through shared memory, so the result is deterministic.
//    Only N*M/32 warps are live (16 x 8 blocks at N=16, M=250), too few to
//    keep HBM busy: a later version splits w across blocks.
//
// 3. ap_contract  replaces noma_rates.py noma_ap_contract_kernel
//                 (_ap_contract_kernel):
//      out[w,m] = sum_n [ap[w] != n] * g * nm[n,m]
//    Bound: bytes (the raw gain read once).
//    Design: one thread per (w, m), threads along m, looping over n < N:
//    APs past N are never visited, the CUDA form of the TPU kernel's
//    explicit out-of-range n mask.
#include <cuda_runtime.h>

#include <cstddef>

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

template <bool UPLINK>
__device__ __forceinline__ float gain(const float* __restrict__ g, int w, int n, int m,
                                      int W, int N, int M) {
  return UPLINK ? g[(static_cast<size_t>(w) * N + n) * M + m]
                : g[(static_cast<size_t>(n) * W + w) * M + m];
}

template <bool UPLINK>
__global__ void __launch_bounds__(kLanes * kWarps)
per_ap_kernel(const int* __restrict__ ap, const float* __restrict__ wgt,
              const float* __restrict__ g, float* __restrict__ out, int W, int N,
              int M) {
  __shared__ float part[kWarps][kLanes];
  const int n = blockIdx.x;
  const int m = blockIdx.y * kLanes + threadIdx.x;
  float acc = 0.f;
  if (m < M) {
    for (int w = threadIdx.y; w < W; w += kWarps) {
      const float term = wgt[static_cast<size_t>(w) * M + m] * gain<UPLINK>(g, w, n, m, W, N, M);
      acc += (ap[w] != n) ? term : 0.f;
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && m < M) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < kWarps; ++y) s += part[y][threadIdx.x];
    out[static_cast<size_t>(n) * M + m] = s;
  }
}

template <bool UPLINK>
__global__ void __launch_bounds__(kLanes * kWarps)
ap_contract_kernel(const int* __restrict__ ap, const float* __restrict__ nm,
                   const float* __restrict__ g, float* __restrict__ out, int W, int N,
                   int M) {
  const int w = blockIdx.x * kWarps + threadIdx.y;
  const int m = blockIdx.y * kLanes + threadIdx.x;
  if (w >= W || m >= M) return;
  const int a = ap[w];
  float acc = 0.f;
  for (int n = 0; n < N; ++n) {
    const float term = gain<UPLINK>(g, w, n, m, W, N, M) * nm[static_cast<size_t>(n) * M + m];
    acc += (a != n) ? term : 0.f;
  }
  out[static_cast<size_t>(w) * M + m] = acc;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

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

int noma_per_ap(const int* ap, const float* wgt, const float* g, float* out, int W,
                int N, int M, int uplink, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N, ceil_div(M, kLanes));
  const dim3 block(kLanes, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uplink) {
    per_ap_kernel<true><<<grid, block, 0, s>>>(ap, wgt, g, out, W, N, M);
  } else {
    per_ap_kernel<false><<<grid, block, 0, s>>>(ap, wgt, g, out, W, N, M);
  }
  return static_cast<int>(cudaGetLastError());
}

int noma_ap_contract(const int* ap, const float* nm, const float* g, float* out, int W,
                     int N, int M, int uplink, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(W, kWarps), ceil_div(M, kLanes));
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
