// Bitmask protocol-sweep kernels for the RegC sharing directory, written
// for Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (ctypes; see ../_build.py and ../protocol_sweep.py).
//
// Packed planes: bit j of 32-bit word k in row w is directory column
// 32*k + j of worker w (little-endian, the reference's bit order at
// src/repro/kernels/protocol_sweep.py:134).  Words are stored as int32
// tensors and read here as uint32.
//
// Every kernel here moves a few bytes per cell and does a handful of
// integer operations per byte, so each is bound by memory traffic on the
// card (HBM3 at 3.35 TB/s); at the protocol's shapes (W = 256 workers,
// windows of ~16k pages) the whole working set is a few MB and the real
// limit is the launch itself.  The designs below therefore aim at one
// coalesced pass over the inputs and at no extra launches.
//
// Every C entry returns cudaGetLastError() so the Python wrapper can raise
// when a launch is refused.

#include <cstdint>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Dynamic shared memory a block may take without opting in: the 48 KiB
// default less room for a kernel's static shared memory and the dynamic
// array's alignment.
constexpr size_t kDefaultDynamicSmem = 46 * 1024;

// Block-wide sum; the result is valid in thread 0.  Contains a
// __syncthreads, so shared-memory writes made before the call are visible
// to the whole block after it.
__device__ long long block_sum(long long v, long long* partial) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? partial[threadIdx.x] : 0;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  }
  return v;
}

// Number of entries of the sorted array a[0, n) that are <= x
// (numpy's searchsorted(a, x, side="right")).
__device__ __forceinline__ int upper_bound(const int* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(a[mid]) <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// pack_rows: (W, C) bool plane -> (W, nw_out) packed words, zero past C.
// Replaces the host-side numpy pack_mask_rows
// (src/repro/kernels/protocol_sweep.py:134) that fed the TPU kernels, so
// the dirty planes never leave the card.  Bound: W*C bytes read plus
// W*nw_out*4 bytes written.  One warp per output word: lane j reads cell
// 32k+j (32 neighbouring bytes, one coalesced transaction per warp) and
// __ballot_sync assembles the word with lane j as bit j.
__global__ void pack_rows_kernel(const uint8_t* __restrict__ plane,
                                 uint32_t* __restrict__ out, long long C,
                                 long long nw_out) {
  const long long k =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (k >= nw_out) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long w = blockIdx.y;
  const long long col = 32 * k + lane;
  const bool bit = col < C && plane[w * C + col] != 0;
  const unsigned word = __ballot_sync(kFull, bit);
  if (lane == 0) out[w * nw_out + k] = word;
}

// popcount_rows: (W, nw) words -> (W,) int64 set-bit counts.
// Replaces _popcount_kernel / _popcount_rows_pallas
// (src/repro/kernels/protocol_sweep.py:223, :232).  Bound: W*nw*4 bytes
// read.  One block per row; threads stride over the row's words so
// neighbouring threads read neighbouring words, __popc does the SWAR work
// of the TPU kernel in one instruction, and a warp-shuffle reduction
// sums the row.
__global__ void popcount_rows_kernel(const uint32_t* __restrict__ bits,
                                     long long* __restrict__ counts,
                                     long long nw) {
  __shared__ long long partial[kWarps];
  const uint32_t* row = bits + static_cast<long long>(blockIdx.x) * nw;
  long long c = 0;
  for (long long k = threadIdx.x; k < nw; k += blockDim.x) c += __popc(row[k]);
  c = block_sum(c, partial);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// coverage_multi: n sorted-bound deltas (+1 window start, -1 window end)
// -> uint8 (running cover >= 2).  Replaces _coverage_kernel /
// _coverage_multi_pallas (src/repro/kernels/protocol_sweep.py:329, :333).
// Bound: n*4 bytes read plus n bytes written; n = 2 * live windows <= 2W.
// One block walks the input in chunks of kThreads: cub::BlockScan gives
// the inclusive sum inside a chunk and a running carry joins the chunks,
// so any n works without a second launch.
__global__ void coverage_multi_kernel(const int* __restrict__ delta,
                                      uint8_t* __restrict__ out,
                                      long long n) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int chunk_total;
  int running = 0;
  for (long long start = 0; start < n; start += kThreads) {
    const long long i = start + threadIdx.x;
    const int x = i < n ? delta[i] : 0;
    int incl;
    Scan(tmp).InclusiveSum(x, incl);
    if (i < n) out[i] = (running + incl) >= 2;
    if (threadIdx.x == kThreads - 1) chunk_total = incl;
    __syncthreads();
    running += chunk_total;
    __syncthreads();  // chunk_total and tmp are reused by the next chunk
  }
}

// phase_step: the fused barrier-flush chain over R stacked regions.
// Replaces _phase_step_jit (src/repro/kernels/protocol_sweep.py:426), the
// TPU tier's one-dispatch flush.  Grid (W, R): one block per (row,
// region).  Per block:
//   1. region r's sorted live window bounds (<= 2W int32, INT32_MAX pads)
//      are staged in shared memory;
//   2. the row's dirty popcount is reduced into counts[r, w], and the row
//      is active iff rowmask[r, w] and the count is > 0;
//   3. each warp takes one word k: lane j forms page = base + 32k + j and
//      cov = upper_bound(sbases, page) - upper_bound(sends, page), the
//      number of live windows containing the page; __ballot_sync(cov >= 2)
//      is the multi-covered mask of the word, and lane 0 stores
//      word & mask (0 for inactive rows and all-zero words).
// A pad entry (INT32_MAX) is never <= a probed page, so it stabs nothing;
// rows with base -1 hold no set bits.  Bound: R*W*nw*4 bytes read plus
// the same written (the geometry adds R*W*13 bytes); the binary searches
// are ~2*log2(W) shared-memory reads per lane and are skipped for
// all-zero words, which dominate sparse dirty planes.
__global__ void phase_step_kernel(const uint32_t* __restrict__ bits,
                                  const int* __restrict__ base,
                                  const uint8_t* __restrict__ rowmask,
                                  const int* __restrict__ sbases,
                                  const int* __restrict__ sends,
                                  long long* __restrict__ counts,
                                  uint32_t* __restrict__ shared, int W,
                                  long long nw) {
  extern __shared__ int bounds[];  // [0, W) starts, [W, 2W) ends
  __shared__ long long partial[kWarps];
  __shared__ long long row_count;
  const long long r = blockIdx.y;
  const long long rw = r * W + blockIdx.x;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    bounds[i] = sbases[r * W + i];
    bounds[W + i] = sends[r * W + i];
  }
  const uint32_t* row = bits + rw * nw;
  uint32_t* out = shared + rw * nw;
  long long c = 0;
  for (long long k = threadIdx.x; k < nw; k += blockDim.x) c += __popc(row[k]);
  c = block_sum(c, partial);  // also publishes the staged bounds
  if (threadIdx.x == 0) {
    counts[rw] = c;
    row_count = c;
  }
  __syncthreads();
  const bool active = rowmask[rw] != 0 && row_count > 0;
  if (!active) {
    for (long long k = threadIdx.x; k < nw; k += blockDim.x) out[k] = 0;
    return;
  }
  const int lane = threadIdx.x & 31;
  const long long b = base[rw];
  for (long long k = threadIdx.x >> 5; k < nw; k += kWarps) {
    const uint32_t word = row[k];  // same address for the warp: broadcast
    if (word == 0) {               // warp-uniform
      if (lane == 0) out[k] = 0;
      continue;
    }
    const long long page = b + 32 * k + lane;
    const int cov = upper_bound(bounds, W, page) -
                    upper_bound(bounds + W, W, page);
    const unsigned multi = __ballot_sync(kFull, cov >= 2);
    if (lane == 0) out[k] = word & multi;
  }
}

// rank_select: the eviction engine's per-row rank-select over packed
// run-liveness masks, one template for three entries, replacing these
// TPU kernels of src/repro/kernels/protocol_sweep.py:
//   take_first_k  <- _take_first_k_pallas   (:266)
//   kth_set_index <- _kth_set_index_pallas  (:310)
//   take_and_cut  <- _take_and_cut_jit      (:415)
// The TPU kernels padded rows to 8-row blocks of 128 lanes and ran 32
// static shift steps per word.  Here one block takes one row: threads
// read consecutive words (coalesced), each word's __popc feeds a
// block-wide exclusive scan (cub::BlockScan) chunk by chunk with a running
// carry, so every thread knows excl = the set bits before its word.
//   take: need = clamp(k - excl, 0, 32); the word stays whole when
//         need >= popc, becomes 0 when need == 0, and otherwise keeps the
//         bits below its (need+1)-th set bit (__fns);
//   cut:  the one thread whose word holds the k-th set bit
//         (excl < k <= excl + popc) writes 32*wi + __fns(word, 0, k - excl)
//         to shared memory; the row's cut stays -1 when k <= 0 or the row
//         has fewer than k set bits.
// Bound: bytes, 2*R*nw*4 + R*12 for take_and_cut (words read once, take
// written once, k read, cut written); a handful of integer operations per
// word.  At the path's shapes (R = 1 row of a few words in the refetch
// replay; R <= 256 rows of <= 1024 words in lru_take) the launch dominates.
template <bool kTake, bool kCut>
__global__ void rank_select_kernel(const uint32_t* __restrict__ bits,
                                   const int* __restrict__ k,
                                   uint32_t* __restrict__ take,
                                   long long* __restrict__ cut,
                                   long long nw) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int chunk_total;
  __shared__ long long found;
  const long long r = blockIdx.x;
  const uint32_t* row = bits + r * nw;
  const long long kk = k[r];
  if (kCut && threadIdx.x == 0) found = -1;
  __syncthreads();
  long long carry = 0;
  for (long long start = 0; start < nw; start += kThreads) {
    const long long wi = start + threadIdx.x;
    const uint32_t word = wi < nw ? row[wi] : 0u;
    const int pc = __popc(word);
    int excl_in;
    Scan(tmp).ExclusiveSum(pc, excl_in);
    const long long excl = carry + excl_in;
    if (kTake && wi < nw) {
      const long long need = kk - excl;
      uint32_t out = 0u;
      if (need >= pc) {
        out = word;
      } else if (need > 0) {
        out = word & ((1u << __fns(word, 0, static_cast<int>(need) + 1)) - 1u);
      }
      take[r * nw + wi] = out;
    }
    if (kCut && excl < kk && kk <= excl + pc) {
      found = 32 * wi + __fns(word, 0, static_cast<int>(kk - excl));
    }
    if (threadIdx.x == kThreads - 1) chunk_total = excl_in + pc;
    __syncthreads();
    carry += chunk_total;
    __syncthreads();  // chunk_total and tmp are reused by the next chunk
  }
  if (kCut && threadIdx.x == 0) cut[r] = found;
}

template <bool kTake, bool kCut>
int launch_rank_select(const void* bits, const void* k, void* take, void* cut,
                       long long R, long long nw, void* stream) {
  if (R > 0 && nw > 0) {
    rank_select_kernel<kTake, kCut>
        <<<static_cast<unsigned>(R), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(bits), static_cast<const int*>(k),
            static_cast<uint32_t*>(take), static_cast<long long*>(cut), nw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rt_take_first_k(const void* bits, const void* k, void* take, long long R,
                    long long nw, void* stream) {
  return launch_rank_select<true, false>(bits, k, take, nullptr, R, nw,
                                         stream);
}

int rt_kth_set_index(const void* bits, const void* k, void* cut, long long R,
                     long long nw, void* stream) {
  return launch_rank_select<false, true>(bits, k, nullptr, cut, R, nw, stream);
}

int rt_take_and_cut(const void* bits, const void* k, void* take, void* cut,
                    long long R, long long nw, void* stream) {
  return launch_rank_select<true, true>(bits, k, take, cut, R, nw, stream);
}

int rt_pack_rows(const void* plane, void* out, long long W, long long C,
                 long long nw_out, void* stream) {
  if (W > 0 && nw_out > 0) {
    const dim3 grid(static_cast<unsigned>((nw_out + kWarps - 1) / kWarps),
                    static_cast<unsigned>(W));
    pack_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(plane), static_cast<uint32_t*>(out), C,
        nw_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_popcount_rows(const void* bits, void* counts, long long W,
                     long long nw, void* stream) {
  if (W > 0) {
    popcount_rows_kernel<<<static_cast<unsigned>(W), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits), static_cast<long long*>(counts),
        nw);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_coverage_multi(const void* delta, void* out, long long n,
                      void* stream) {
  if (n > 0) {
    coverage_multi_kernel<<<1, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(delta), static_cast<uint8_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_phase_step(const void* bits, const void* base, const void* rowmask,
                  const void* sbases, const void* sends, void* counts,
                  void* shared, long long R, long long W, long long nw,
                  void* stream) {
  if (R > 0 && W > 0) {
    const dim3 grid(static_cast<unsigned>(W), static_cast<unsigned>(R));
    const size_t smem = 2 * static_cast<size_t>(W) * sizeof(int);
    if (smem > kDefaultDynamicSmem) {
      // past the default, opt in to Hopper's larger shared memory (up to
      // 227 KiB a block); a request the card cannot give is returned
      const cudaError_t e = cudaFuncSetAttribute(
          phase_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    phase_step_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits), static_cast<const int*>(base),
        static_cast<const uint8_t*>(rowmask),
        static_cast<const int*>(sbases), static_cast<const int*>(sends),
        static_cast<long long*>(counts), static_cast<uint32_t*>(shared),
        static_cast<int>(W), nw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
