// Mamba-2 SSD intra-chunk block of the model path's prefill, written for
// Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (ctypes; see ../_build.py and ../ssd_chunk.py).
//
// Replaces _ssd_chunk_kernel / ssd_chunk
// (src/repro/kernels/ssd_chunk.py:26, :52).  For each cell m (one batch
// row, chunk and head) with chunk length Q, head dim P and state dim N:
//   y[i]  = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   state = sum_j (x_j * exp(cum_{Q-1} - cum_j) * dt_j) (outer) B_j
// with x, B, C in f32 or bf16, dt and cum in f32, and f32 outputs
// y (M, Q, P) and state (M, P, N).
//
// What bounds it on this card: the function needs C.B^T over the
// Q(Q+1)/2 causal pairs (2N flops each) once per B/C group, and per cell
// Q(Q+1)/2 * 2P + 2QPN flops for the scores times x and the state; at
// mamba2-2.7b's Q = 256, P = 64, N = 128 that is tens of flops a byte, so
// it is bound by arithmetic.  This first kernel runs in f32 on CUDA cores
// (67 TFLOP/s peak) and RECOMPUTES C.B^T in every cell, i.e. rep times per
// group (80 times at mamba2-2.7b), about twice the arithmetic the function
// needs there: removing that recomputation (form C.B^T once per group and
// chunk, then apply it to the group's heads) is the first step of its
// redesign, before tensor cores.
//
// Design.  The TPU kernel holds a whole cell in VMEM, the (Q, Q) score
// matrix included (256 KB at Q = 256); a Hopper block cannot, so the cell
// is cut over query rows:
//   * blocks (m, t) for t < ceil(Q / 64) own 64 query rows: their C rows
//     stay in shared memory, and a loop walks the key tiles of 32 rows up
//     to the diagonal (the causal half only), staging B, x, cum and dt;
//     each thread forms 4 x 2 entries of C.B^T, scales them by the decay
//     and dt, and the tile goes through shared memory into the y
//     accumulator (4 rows x P/16 columns a thread, in registers);
//   * the mask is applied BEFORE the exp: entries above the diagonal are
//     set to 0 without evaluating exp(cum_i - cum_j), which would overflow
//     to inf there (the reference masks to -inf first for the same
//     reason, ssd_chunk.py:36-40);
//   * the state comes from the same launch: block (m, ceil(Q / 64))
//     walks all Q rows and accumulates the (P, N) outer products, P*N/256
//     outputs a thread;
//   * the B and C rows of cell m are row m / rep of their arrays, so one
//     B/C group shared by rep consecutive heads (mamba2-2.7b: 80 heads,
//     one group) is read where it lies instead of being repeated per cell;
//   * any Q >= 1: rows past Q are zero filled and never stored.
// Shared memory at N = 128, P = 64 is 66,432 bytes, over the 48 KiB
// default, so each launch opts in with cudaFuncSetAttribute.
//
// The C entry returns cudaGetLastError() so the Python wrapper can raise
// when a launch is refused.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBI = 64;         // query rows per block
constexpr int kBJ = 32;         // key rows per tile
constexpr int kThreads = 256;   // 16 x 16: tx picks columns, ty rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int smem_bytes(int P, int N) {
  // the larger of the row-tile blocks' and the state block's layout
  return (kBI * (N + 1) + kBJ * (N + 1) + kBJ * P + kBI * (kBJ + 1) +
          2 * kBJ) * static_cast<int>(sizeof(float));
}

template <typename T, int P, int N>
__device__ void chunk_rows(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ cum,
                           const T* __restrict__ Bg, const T* __restrict__ Cg,
                           float* __restrict__ y, int Q, int i0,
                           float* smem) {
  float* Cs = smem;                    // [kBI][N + 1]
  float* Bs = Cs + kBI * (N + 1);      // [kBJ][N + 1]
  float* Xs = Bs + kBJ * (N + 1);      // [kBJ][P]
  float* Ps = Xs + kBJ * P;            // [kBI][kBJ + 1]
  float* cum_j = Ps + kBI * (kBJ + 1); // [kBJ]
  float* dt_j = cum_j + kBJ;           // [kBJ]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < kBI * N; e += kThreads) {
    const int r = e / N, n = e % N, i = i0 + r;
    Cs[r * (N + 1) + n] = i < Q ? to_f(Cg[i * N + n]) : 0.f;
  }
  float cum_i[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    cum_i[a] = i < Q ? cum[i] : 0.f;
  }
  constexpr int PJ = P / 16;
  float acc[4][PJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < PJ; ++c) acc[a][c] = 0.f;

  const int j_end = min(Q, i0 + kBI);  // causal: j <= i < i0 + kBI
  for (int j0 = 0; j0 < j_end; j0 += kBJ) {
    __syncthreads();  // Cs staged; the last tile's reads are done
    for (int e = tid; e < kBJ * N; e += kThreads) {
      const int r = e / N, n = e % N, j = j0 + r;
      Bs[r * (N + 1) + n] = j < Q ? to_f(Bg[j * N + n]) : 0.f;
    }
    for (int e = tid; e < kBJ * P; e += kThreads) {
      const int r = e / P, p = e % P, j = j0 + r;
      Xs[e] = j < Q ? to_f(x[j * P + p]) : 0.f;
    }
    if (tid < kBJ) {
      const int j = j0 + tid;
      cum_j[tid] = j < Q ? cum[j] : 0.f;
      dt_j[tid] = j < Q ? dt[j] : 0.f;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) sc[a][0] = sc[a][1] = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty * 4 + a) * (N + 1) + n];
#pragma unroll
      for (int c = 0; c < 2; ++c) bv[c] = Bs[(tx + 16 * c) * (N + 1) + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) sc[a][c] = fmaf(cv[a], bv[c], sc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jj = tx + 16 * c, j = j0 + jj;
        float s = 0.f;  // masked before the exp: no exp above the diagonal
        if (j <= i && i < Q && j < Q)
          s = sc[a][c] * expf(cum_i[a] - cum_j[jj]) * dt_j[jj];
        Ps[(ty * 4 + a) * (kBJ + 1) + jj] = s;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBJ; ++kk) {
      float xv[PJ];
#pragma unroll
      for (int c = 0; c < PJ; ++c) xv[c] = Xs[kk * P + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Ps[(ty * 4 + a) * (kBJ + 1) + kk];
#pragma unroll
        for (int c = 0; c < PJ; ++c) acc[a][c] = fmaf(p, xv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= Q) continue;
#pragma unroll
    for (int c = 0; c < PJ; ++c) y[i * P + tx + 16 * c] = acc[a][c];
  }
}

template <typename T, int P, int N>
__device__ void chunk_state(const T* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ cum,
                            const T* __restrict__ Bg, float* __restrict__ st,
                            int Q, float* smem) {
  float* Xs = smem;          // [kBJ][P], x_j * exp(cum_last - cum_j) * dt_j
  float* Bs = Xs + kBJ * P;  // [kBJ][N]
  constexpr int K = P * N / kThreads;
  const int tid = threadIdx.x;
  const float last = cum[Q - 1];
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kBJ) {
    __syncthreads();
    for (int e = tid; e < kBJ * P; e += kThreads) {
      const int r = e / P, p = e % P, j = j0 + r;
      Xs[e] = j < Q ? to_f(x[j * P + p]) * (expf(last - cum[j]) * dt[j])
                    : 0.f;
    }
    for (int e = tid; e < kBJ * N; e += kThreads) {
      const int r = e / N, n = e % N, j = j0 + r;
      Bs[e] = j < Q ? to_f(Bg[j * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBJ; ++kk) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int o = tid + kThreads * c;
        acc[c] = fmaf(Xs[kk * P + o / N], Bs[kk * N + o % N], acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) st[tid + kThreads * c] = acc[c];
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ st, int Q, int rep, int row_tiles) {
  extern __shared__ float smem[];
  const long long m = blockIdx.x;
  const long long g = m / rep;
  const long long q = Q;
  if (static_cast<int>(blockIdx.y) == row_tiles) {
    chunk_state<T, P, N>(x + m * q * P, dt + m * q, cum + m * q,
                         Bm + g * q * N, st + m * P * N, Q, smem);
  } else {
    chunk_rows<T, P, N>(x + m * q * P, dt + m * q, cum + m * q,
                        Bm + g * q * N, Cm + g * q * N, y + m * q * P, Q,
                        static_cast<int>(blockIdx.y) * kBI, smem);
  }
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* cum, const void* B,
           const void* C, void* y, void* st, long long M, long long Q,
           long long rep, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(P, N);
  cudaFuncSetAttribute(ssd_chunk_kernel<T, P, N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int row_tiles = static_cast<int>((Q + kBI - 1) / kBI);
  const dim3 grid(static_cast<unsigned>(M),
                  static_cast<unsigned>(row_tiles + 1));
  ssd_chunk_kernel<T, P, N><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<int>(Q), static_cast<int>(rep),
      row_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_n(long long N, const void* x, const void* dt, const void* cum,
               const void* B, const void* C, void* y, void* st, long long M,
               long long Q, long long rep, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, cum, B, C, y, st, M, Q, rep, s);
    case 32: return launch<T, P, 32>(x, dt, cum, B, C, y, st, M, Q, rep, s);
    case 64: return launch<T, P, 64>(x, dt, cum, B, C, y, st, M, Q, rep, s);
    case 128: return launch<T, P, 128>(x, dt, cum, B, C, y, st, M, Q, rep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_p(long long P, long long N, const void* x, const void* dt,
               const void* cum, const void* B, const void* C, void* y,
               void* st, long long M, long long Q, long long rep,
               cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(N, x, dt, cum, B, C, y, st, M, Q, rep, s);
    case 32: return dispatch_n<T, 32>(N, x, dt, cum, B, C, y, st, M, Q, rep, s);
    case 64: return dispatch_n<T, 64>(N, x, dt, cum, B, C, y, st, M, Q, rep, s);
    case 128:
      return dispatch_n<T, 128>(N, x, dt, cum, B, C, y, st, M, Q, rep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (of x, B and C): 0 float32, 1 bfloat16; dt and cum are float32.
// x (M, Q, P), dt and cum (M, Q), B and C (M / rep, Q, N), all contiguous;
// y (M, Q, P) and state (M, P, N) float32.
extern "C" int rt_ssd_chunk(const void* x, const void* dt, const void* cum,
                            const void* B, const void* C, void* y, void* st,
                            int dtype, long long M, long long Q, long long P,
                            long long N, long long rep, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_p<float>(P, N, x, dt, cum, B, C, y, st, M, Q, rep, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(P, N, x, dt, cum, B, C, y, st, M, Q,
                                     rep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
