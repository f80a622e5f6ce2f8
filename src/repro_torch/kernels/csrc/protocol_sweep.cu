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

// Bool planes are read in place: word k of a row of C cells is cells
// [32k, 32k + 32), bit j = cell 32k + j != 0, cells at or past C read as
// 0.  One thread forms one word from its 32 bytes.  Where the word's
// bytes start on a 16-byte boundary that is two 16-byte loads; where
// they do not (a cap that is not a multiple of 16 shifts every row) it
// is the three aligned 16-byte chunks around them, cut with one shift,
// as long as those chunks lie inside the plane; the row's ragged last
// word, and a word whose chunks would leave the plane, take byte loads.
// Neighbouring threads read neighbouring 32-byte runs, so a warp's loads
// cover 1 KiB of the row contiguously.

// The four bytes of x, each 0 or not, as four bits (byte i -> bit i):
// __vcmpne4 sets a byte to 0xff where it is not 0, the mask keeps one bit
// a byte, and the multiply gathers them into bits 24..27 without carries.
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t bits16(const uint4* q) {
  const uint4 v = __ldg(q);
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
         nibble(v.w) << 12;
}

// Word k of ``row`` (C cells); [lo, hi) are the plane's bytes, which no
// load leaves.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row,
                                              long long k, long long C,
                                              const uint8_t* lo,
                                              const uint8_t* hi) {
  const long long c0 = 32 * k;
  const uint8_t* p = row + c0;
  if (c0 + 32 <= C) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const unsigned s = static_cast<unsigned>(a & 15u);
    const uint4* q = reinterpret_cast<const uint4*>(a - s);
    if (s == 0) return bits16(q) | bits16(q + 1) << 16;
    if (reinterpret_cast<const uint8_t*>(q) >= lo &&
        reinterpret_cast<const uint8_t*>(q + 3) <= hi) {
      const unsigned long long m =
          bits16(q) | static_cast<unsigned long long>(bits16(q + 1)) << 16 |
          static_cast<unsigned long long>(bits16(q + 2)) << 32;
      return static_cast<uint32_t>(m >> s);
    }
  }
  const int n = static_cast<int>(C - c0 < 32 ? C - c0 : 32);
  uint32_t word = 0;
  for (int j = 0; j < n; ++j) word |= static_cast<uint32_t>(p[j] != 0) << j;
  return word;
}

// pack_rows: (W, C) bool plane -> (W, nw_out) packed words, zero past C.
// Replaces the host-side numpy pack_mask_rows
// (src/repro/kernels/protocol_sweep.py:134) that fed the TPU kernels, so
// the planes never leave the card.  Bound: W*C bytes read plus
// W*nw_out*4 bytes written.  One thread per output word (load_word),
// neighbouring threads on neighbouring words, so both the reads and the
// stores are coalesced; a grid of a few blocks per SM strides over the
// W*nw_out words.
__global__ void pack_rows_kernel(const uint8_t* __restrict__ plane,
                                 uint32_t* __restrict__ out, long long W,
                                 long long C, long long nw_out) {
  const long long nw = (C + 31) / 32;
  const long long total = W * nw_out;
  const uint8_t* hi = plane + W * C;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long w = i / nw_out;
    const long long k = i - w * nw_out;
    out[i] = k < nw ? load_word(plane + w * C, k, C, plane, hi) : 0u;
  }
}

// popcount_rows: (R, C) bool rows -> (R,) int64 counts of nonzero
// cells.  Replaces _popcount_kernel / _popcount_rows_pallas
// (src/repro/kernels/protocol_sweep.py:223, :232), which counted the
// words of rows packed beforehand (the host's pack_mask_rows, :134).
// Packing first would cost a second launch (and a copy for a column
// window), so the rows are read in place, from a pointer and a row
// stride, and no word is formed: each 16-byte load's nonzero bytes are
// counted four at a time (nonzero4, the nonzero test of load_word, so
// mask bytes of 2 or 0xff count as one).  A row's bytes before its
// first 16-byte boundary and after its last take one byte load a
// thread; the aligned chunks between are striped over the row's threads
// (chunk t, t + n, ...), four loads in flight a thread, so a warp's
// loads cover 512 contiguous bytes a step.  A row of at most 1024 cells
// (the refetch replay's runs) is one warp, reduced by shuffles; a
// longer one is one block, whose warps' sums meet in one shared word
// each (block_sum).  One launch covers every row.
// Bound: bytes, R*C read once and R*8 written; at the barrier flush's
// 256 x 16384 plane that is 4 MiB, 1.25 us at 3.35 TB/s.

// The nonzero bytes of x: __vcmpne4 sets a byte to 0xff where it is not
// 0, and the mask keeps one bit a byte.
__device__ __forceinline__ int nonzero4(uint32_t x) {
  return __popc(__vcmpne4(x, 0u) & 0x01010101u);
}

__device__ __forceinline__ int nonzero16(const uint4 v) {
  return nonzero4(v.x) + nonzero4(v.y) + nonzero4(v.z) + nonzero4(v.w);
}

// Thread t's share of the nonzero cells of row [p, p + C), counted by n
// threads (n >= 16).
__device__ __forceinline__ long long count_row(const uint8_t* p, long long C,
                                               int t, int n) {
  const long long skew =
      static_cast<long long>(reinterpret_cast<uintptr_t>(p) & 15u);
  const long long head = skew == 0 ? 0 : (16 - skew < C ? 16 - skew : C);
  const long long chunks = (C - head) >> 4;
  const long long tail = head + 16 * chunks;  // the ragged tail's first cell
  const uint4* q = reinterpret_cast<const uint4*>(p + head);
  long long c = 0;
  if (t < head) c += __ldg(p + t) != 0;
  if (t < C - tail) c += __ldg(p + tail + t) != 0;
  long long i = t;
  for (; i + 3ll * n < chunks; i += 4ll * n) {
    const uint4 v0 = __ldg(q + i);
    const uint4 v1 = __ldg(q + i + n);
    const uint4 v2 = __ldg(q + i + 2ll * n);
    const uint4 v3 = __ldg(q + i + 3ll * n);
    c += nonzero16(v0) + nonzero16(v1) + nonzero16(v2) + nonzero16(v3);
  }
  for (; i < chunks; i += n) c += nonzero16(__ldg(q + i));
  return c;
}

template <bool kWarpRow>
__global__ void __launch_bounds__(kThreads)
    popcount_rows_kernel(const uint8_t* __restrict__ plane, long long stride,
                         long long R, long long C,
                         long long* __restrict__ counts) {
  if constexpr (kWarpRow) {  // a row a warp, C <= 1024
    const long long r =
        static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
        (threadIdx.x >> 5);
    if (r >= R) return;  // warp-uniform
    long long c = count_row(plane + r * stride, C, threadIdx.x & 31, 32);
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
    if ((threadIdx.x & 31) == 0) counts[r] = c;
  } else {  // a row a block
    __shared__ long long partial[kWarps];
    const long long r = blockIdx.x;
    long long c = count_row(plane + r * stride, C, threadIdx.x, kThreads);
    c = block_sum(c, partial);
    if (threadIdx.x == 0) counts[r] = c;
  }
}

// coverage_multi: a region's sorted live window starts and ends (n each,
// int64, ascending) -> the 2n merged sweep points, then their 2n flags
// (1 where the running cover after the point is >= 2), in one int64
// buffer that the host reads back in one copy.  Replaces _coverage_kernel
// / _coverage_multi_pallas (src/repro/kernels/protocol_sweep.py:329,
// :333), a running sum over the +1/-1 deltas that the host sorted (a
// stable argsort of the concatenated bounds) and uploaded on every
// flush.  Here the bounds stay on the card between window changes
// (the directory caches them) and the merge is the kernel's: one
// thread a bound places it and its cover with one binary search in the
// other array, in the reference's stable order (at equal values every
// start before every end):
//   start i of value v: with e = #(ends < v), position i + e and
//                       cover (i + 1) - e;
//   end j of value u:   with s = #(starts <= u), position j + s and
//                       cover s - (j + 1).
// No scan, no barrier, no shared memory and no limit from one block; on
// sorted bounds each position is written by one thread, and any input
// keeps the writes inside [0, 2n).  int64 keeps page ids past INT32_MAX
// exact.
// Bound: bytes, 2n*8 read and 4n*8 written (12 KiB at 2W = 512 bounds,
// 0.0037 us); a launch costs more than that whatever the design, so the
// gain is on the path: no host sort and no upload a flush.
// The number of entries of the sorted a[0, n) that are < x, or <= x
// when kUpper (numpy's searchsorted, side "left" or "right").
template <bool kUpper>
__device__ __forceinline__ long long search(const long long* a, long long n,
                                            long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long v = __ldg(a + mid);
    if (kUpper ? v <= x : v < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    coverage_multi_kernel(const long long* __restrict__ bounds, long long n,
                          long long* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  long long value, pos, cover;
  if (i < n) {  // start i
    value = __ldg(bounds + i);
    const long long before = search<false>(bounds + n, n, value);
    pos = i + before;
    cover = i + 1 - before;
  } else {  // end j
    const long long j = i - n;
    value = __ldg(bounds + i);
    const long long opened = search<true>(bounds, n, value);
    pos = j + opened;
    cover = opened - (j + 1);
  }
  out[pos] = value;
  out[2 * n + pos] = cover >= 2;
}

// Bits [a, b) of a word, 0 <= a < b <= 32.
__device__ __forceinline__ uint32_t bit_span(long long a, long long b) {
  return static_cast<uint32_t>(((1ull << b) - 1) & ~((1ull << a) - 1));
}

// The multi-covered mask of the 32 pages [P, P + 32): bit j is set iff at
// least two live windows contain page P + j, i.e. cov(p) = #{starts <= p}
// - #{ends <= p} >= 2 over the sorted bounds sb/se (W each, INT32_MAX
// pads, which stab nothing).  cov is constant between consecutive bound
// values, so one stab at P (two upper_bounds) and the least start or end
// above P decide the word: past P + 31 the mask is all ones or all zeros;
// otherwise the walk steps over the few bounds inside the word.
__device__ __forceinline__ uint32_t multi_mask(const int* sb, const int* se,
                                               int W, long long P) {
  constexpr long long kNone = 1ll << 62;
  int i = upper_bound(sb, W, P);
  int j = upper_bound(se, W, P);
  long long cur = P;
  uint32_t mask = 0;
  for (;;) {
    const long long s = i < W ? sb[i] : kNone;
    const long long e = j < W ? se[j] : kNone;
    const long long next = s < e ? s : e;
    const long long stop = next < P + 32 ? next : P + 32;
    if (i - j >= 2) mask |= bit_span(cur - P, stop - P);
    if (next >= P + 32) return mask;
    while (i < W && sb[i] == next) ++i;
    while (j < W && se[j] == next) ++j;
    cur = next;
  }
}

// phase_step: the fused barrier flush over the dirty regions, read from
// their bool dirty planes as they lie.  Replaces _phase_step_jit
// (src/repro/kernels/protocol_sweep.py:426), the TPU tier's one-dispatch
// flush over stacked packed planes.
//
// The regions' planes, (3, W) int32 geometries (base, sorted starts,
// sorted ends with INT32_MAX pads) and caps come by value, up to
// kMaxRegions a launch (a larger flush takes one launch more for each
// kMaxRegions, in the same C call).  Grid (W, regions): one block per
// (row, region).  Each thread forms one 32-page word at a time from the
// bool row (load_word: nothing is packed beforehand), the next trip's
// word loading while this one is worked on, and adds its __popc to the
// row's count, reduced by warp shuffles and a block sum into
// out[r*W + w].  On an active row (rowmask, where given) the block stages
// the region's 2W sorted bounds in shared memory, and a nonzero word's
// multi-covered mask is one stab of its own (multi_mask).  word & mask,
// where nonzero, is a candidate: a warp reserves slots for its
// candidates with one atomicAdd on ws[0] and writes each as
// (key = (r*W + w) << 32 | k, word) into the entries after the counts;
// a slot at or past ``capacity`` (more entries than the flush has words:
// counters left stale by a refused launch) is not written, and the host
// raises on the n it reads.  Entries land in no fixed order; the host
// sorts them by key, which is the reference's row-major,
// column-ascending order.  The last block of each launch (ws[1] counts
// finished blocks) resets the counters, and that of the flush's last
// launch writes the number of entries to out[R*W] first, so the host
// reads counts and that number in one copy and the entries in at most
// one more.  The counters start at zero and are left at zero.
//
// Bound: bytes, the planes read once (R*W*cap) plus geometry, counts and
// the entries written.  The parent design packed the planes first (R
// pack_rows launches, a stacked copy written and read again), read one
// word per warp and ran two binary searches per page.
constexpr int kMaxRegions = 32;

struct PhaseRegions {
  const uint8_t* plane[kMaxRegions];
  const int* geom[kMaxRegions];
  long long cap[kMaxRegions];
};

__global__ void phase_step_kernel(const PhaseRegions regions, int r0, int W,
                                  const uint8_t* __restrict__ rowmask,
                                  long long* __restrict__ out,
                                  unsigned* __restrict__ ws, long long n_at,
                                  long long capacity, bool last_launch) {
  extern __shared__ int bounds[];  // [0, W) starts, [W, 2W) ends
  __shared__ long long partial[kWarps];
  const int rl = blockIdx.y;
  const int w = blockIdx.x;
  const long long r = r0 + rl;
  const int* geom = regions.geom[rl];
  const uint8_t* plane = regions.plane[rl];
  const long long C = regions.cap[rl];
  const uint8_t* row = plane + static_cast<long long>(w) * C;
  const uint8_t* hi = plane + static_cast<long long>(W) * C;
  const long long nw = (C + 31) / 32;
  // the first trip's word, loading while the bounds are staged
  uint32_t next = threadIdx.x < nw ? load_word(row, threadIdx.x, C, plane, hi)
                                   : 0u;
  const bool active = rowmask == nullptr || rowmask[r * W + w] != 0;
  const long long base = geom[w];
  const int lane = threadIdx.x & 31;
  if (active) {  // block-uniform
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      bounds[i] = geom[W + i];
      bounds[W + i] = geom[2 * W + i];
    }
    __syncthreads();
  }
  long long* entries = out + n_at + 1;
  long long c = 0;
  for (long long k0 = 0; k0 < nw; k0 += kThreads) {  // block-uniform trips
    const long long k = k0 + threadIdx.x;
    const uint32_t word = next;
    next = k + kThreads < nw ? load_word(row, k + kThreads, C, plane, hi)
                             : 0u;
    c += __popc(word);
    const uint32_t hit =
        word != 0 && active
            ? word & multi_mask(bounds, bounds + W, W, base + 32 * k)
            : 0u;
    const unsigned vote = __ballot_sync(kFull, hit != 0);
    if (vote == 0) continue;  // warp-uniform
    unsigned slot = 0;
    if (lane == 0) slot = atomicAdd(&ws[0], static_cast<unsigned>(__popc(vote)));
    slot = __shfl_sync(kFull, slot, 0) + __popc(vote & ((1u << lane) - 1u));
    if (hit && slot < capacity) {
      entries[2 * static_cast<long long>(slot)] = (r * W + w) << 32 | k;
      entries[2 * static_cast<long long>(slot) + 1] = hit;
    }
  }
  c = block_sum(c, partial);
  if (threadIdx.x == 0) {
    out[r * W + w] = c;
    __threadfence();  // this block's reservations before its ticket
    const unsigned ticket = atomicAdd(&ws[1], 1u);
    if (ticket == gridDim.x * gridDim.y - 1) {  // every block has reserved
      atomicExch(&ws[1], 0u);
      if (last_launch) out[n_at] = atomicExch(&ws[0], 0u);
    }
  }
}

// rank_select: the eviction engine's per-row rank-select, read from the
// bool run planes as they lie; one template for three entries, replacing
// these TPU kernels of src/repro/kernels/protocol_sweep.py, each composed
// with the host's pack_mask_rows (:134) before it and unpack_mask_rows
// (:150) after it:
//   take_first_k  <- _take_first_k_pallas   (:266)
//   kth_set_index <- _kth_set_index_pallas  (:310)
//   take_and_cut  <- _take_and_cut_jit      (:415)
// The TPU kernels took packed words (8-row blocks of 128 lanes, 32 static
// shift steps per word), so the parent design packed every run first
// (pack_rows), scanned one word a thread in chunks of 256 with two
// __syncthreads a chunk, and the caller unpacked the packed take (about
// six elementwise kernels) and read the cut and the take's columns back
// in two more syncs.  Here the kernel forms each row's 32-cell words
// itself (load_word: nothing is packed beforehand), from rows given by a
// pointer and a row stride (a view such as plane[w, a:b] needs no copy),
// and writes what the caller reads:
//   take: the bool (R, C) mask of each row's first k set cells, 32 cells
//         a word, with two 16-byte stores where the word's cells are
//         16-byte aligned;
//   cut:  the column of the k-th set cell, -1 when k <= 0 or the row has
//         fewer than k set cells;
//   list: for one run, [cut, count, col_0 .. col_{count-1}] of the taken
//         cells (count = clamp(k, 0, set cells)) in one int64 buffer, so
//         the host reads the victim scan back in one copy; the 'kernels'
//         tier's take_first_k and kth_set_index fill the two parts of one
//         buffer.
// Ranks come as an int32 vector of R, or one rank by value (R == 1), so
// the one-run form copies nothing to the card.  A row of at most 32 words
// (1024 cells, the refetch replay's runs) is one warp: a word a lane and a
// shuffle scan, no shared memory and no __syncthreads.  A longer row is
// one block that takes kRankWords * kThreads words a round, kRankWords
// words a thread held in registers: word j*kThreads + t of the round is
// thread t's j-th, so a warp's loads and stores of each j cover 32
// neighbouring words (1 KiB of cells) and coalesce.  The round's prefix
// counts are one scan: each warp scans its lanes' counts for each j by
// shuffles, and one warp scans the 32 warp sums (round-major, which is
// word order), so a row of 1024 words (the lru_take shape) takes one
// round with two __syncthreads.  Every word's excl (set cells before it)
// then gives its take (__fns picks the cut-off bit), its columns' slots
// in the list, and whether it holds the k-th cell.
// Bound: bytes, the bool rows read once, the bool take (R*C) and the cut
// or the list written, the ranks read; a few integer operations a word.
constexpr int kRankWords = 4;
// one warp scans the round's warp sums
static_assert(kRankWords * kWarps == 32, "kRankWords * kWarps != 32");

struct RankIn {
  const uint8_t* plane;  // row r at plane + r * stride, C cells
  const uint8_t* hi;     // one past the view's last byte
  long long stride, R, C;
  const int* k;          // R ranks, or null: k_val for the one row
  long long k_val;
};

struct RankOut {
  uint8_t* take;    // (R, C) contiguous, or null
  long long* cut;   // (R,), or null
  long long* list;  // one run: [cut, count, columns...], or null
};

// A cell a byte: the four bits of ``nib`` as bytes of 0 or 1 (the
// multiply spreads bit i to bit 8i, with no carries).
__device__ __forceinline__ uint32_t cells4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// Word wi of a take row (C cells): 32 cells as bytes.
__device__ __forceinline__ void store_cells(uint8_t* row, long long wi,
                                            long long C, uint32_t t) {
  uint8_t* p = row + 32 * wi;
  if (32 * wi + 32 <= C && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    uint4* q = reinterpret_cast<uint4*>(p);
    q[0] = make_uint4(cells4(t & 15u), cells4(t >> 4 & 15u),
                      cells4(t >> 8 & 15u), cells4(t >> 12 & 15u));
    q[1] = make_uint4(cells4(t >> 16 & 15u), cells4(t >> 20 & 15u),
                      cells4(t >> 24 & 15u), cells4(t >> 28));
    return;
  }
  const int n = static_cast<int>(C - 32 * wi < 32 ? C - 32 * wi : 32);
  for (int j = 0; j < n; ++j) p[j] = static_cast<uint8_t>(t >> j & 1u);
}

// Word wi of row r holds ``pc`` set cells with ``excl`` before it.
template <bool kTake, bool kCut>
__device__ __forceinline__ void select_word(const RankOut& out, long long r,
                                            long long C, long long wi,
                                            uint32_t word, int pc,
                                            long long excl, long long kk) {
  if (kTake) {
    const long long need = kk - excl;
    uint32_t t = 0u;
    if (need >= pc) {
      t = word;
    } else if (need > 0) {
      t = word & ((1u << __fns(word, 0, static_cast<int>(need) + 1)) - 1u);
    }
    if (out.take != nullptr) store_cells(out.take + r * C, wi, C, t);
    if (out.list != nullptr) {
      for (long long i = 2 + excl; t != 0u; t &= t - 1u, ++i) {
        out.list[i] = 32 * wi + __ffs(t) - 1;
      }
    }
  }
  if (kCut && excl < kk && kk <= excl + pc) {
    const long long col =
        32 * wi + __fns(word, 0, static_cast<int>(kk - excl));
    if (out.list != nullptr) {
      out.list[0] = col;
    } else {
      out.cut[r] = col;
    }
  }
}

// Row r's ``total`` set cells are known: the cut where no word held the
// k-th cell, and the list's count.
template <bool kTake, bool kCut>
__device__ __forceinline__ void finish_row(const RankOut& out, long long r,
                                           long long total, long long kk) {
  if (kCut && (kk <= 0 || total < kk)) {
    if (out.list != nullptr) {
      out.list[0] = -1;
    } else {
      out.cut[r] = -1;
    }
  }
  if (kTake && out.list != nullptr) {
    out.list[1] = kk <= 0 ? 0 : (kk < total ? kk : total);
  }
}

template <bool kTake, bool kCut, bool kWarpRow>
__global__ void __launch_bounds__(kThreads)
    rank_select_kernel(const RankIn in, const RankOut out) {
  const long long C = in.C;
  const long long nw = (C + 31) / 32;
  if constexpr (kWarpRow) {  // a row a warp, nw <= 32
    const long long r =
        static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
        (threadIdx.x >> 5);
    if (r >= in.R) return;  // warp-uniform
    const int lane = threadIdx.x & 31;
    const uint8_t* row = in.plane + r * in.stride;
    const long long kk = in.k != nullptr ? in.k[r] : in.k_val;
    const uint32_t word =
        lane < nw ? load_word(row, lane, C, in.plane, in.hi) : 0u;
    const int pc = __popc(word);
    int incl = pc;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (lane < nw) {
      select_word<kTake, kCut>(out, r, C, lane, word, pc, incl - pc, kk);
    }
    if (lane == 0) finish_row<kTake, kCut>(out, r, total, kk);
  } else {  // a row a block, in chunks of kThreads * kRankWords words
    __shared__ int part[kRankWords * kWarps];  // round-major warp sums
    __shared__ int chunk;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long r = blockIdx.x;
    const uint8_t* row = in.plane + r * in.stride;
    const long long kk = in.k != nullptr ? in.k[r] : in.k_val;
    long long carry = 0;
    for (long long w0 = 0; w0 < nw; w0 += kThreads * kRankWords) {
      uint32_t word[kRankWords];
      int pc[kRankWords], incl[kRankWords];
#pragma unroll
      for (int j = 0; j < kRankWords; ++j) {
        const long long wi = w0 + j * kThreads + threadIdx.x;
        word[j] = wi < nw ? load_word(row, wi, C, in.plane, in.hi) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kRankWords; ++j) {
        pc[j] = __popc(word[j]);
        incl[j] = pc[j];
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl[j], o);
          if (lane >= o) incl[j] += v;
        }
        if (lane == 31) part[j * kWarps + warp] = incl[j];
      }
      __syncthreads();
      if (warp == 0) {  // the 32 warp sums, in word order, by one warp
        const int v = part[lane];
        int x = v;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(kFull, x, o);
          if (lane >= o) x += u;
        }
        part[lane] = x - v;
        if (lane == 31) chunk = x;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRankWords; ++j) {
        const long long wi = w0 + j * kThreads + threadIdx.x;
        if (wi < nw) {
          select_word<kTake, kCut>(out, r, C, wi, word[j], pc[j],
                                   carry + part[j * kWarps + warp] +
                                       incl[j] - pc[j],
                                   kk);
        }
      }
      carry += chunk;
      __syncthreads();  // part and chunk are reused by the next chunk
    }
    if (threadIdx.x == 0) finish_row<kTake, kCut>(out, r, carry, kk);
  }
}

template <bool kTake, bool kCut>
int launch_rank_select(const void* plane, long long stride, long long R,
                       long long C, const void* k, long long k_val,
                       const RankOut& out, void* stream) {
  if (R > 0) {
    const auto* p = static_cast<const uint8_t*>(plane);
    const RankIn in = {p, p + (R - 1) * stride + C, stride, R, C,
                       static_cast<const int*>(k), k_val};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C <= 32 * 32) {
      const long long per = R < kWarps ? R : kWarps;  // rows a block
      rank_select_kernel<kTake, kCut, true>
          <<<static_cast<unsigned>((R + per - 1) / per),
             static_cast<unsigned>(32 * per), 0, s>>>(in, out);
    } else {
      rank_select_kernel<kTake, kCut, false>
          <<<static_cast<unsigned>(R), kThreads, 0, s>>>(in, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The rank-select entries: ``plane`` (R, C) bool rows ``stride`` bytes
// apart; ranks ``k`` (R int32 on the card) or, where k is null, ``k_val``
// for the one row; outputs as in RankOut, each may be null.
int rt_take_first_k(const void* plane, long long stride, long long R,
                    long long C, const void* k, long long k_val, void* take,
                    void* list, void* stream) {
  const RankOut out = {static_cast<uint8_t*>(take), nullptr,
                       static_cast<long long*>(list)};
  return launch_rank_select<true, false>(plane, stride, R, C, k, k_val, out,
                                         stream);
}

int rt_kth_set_index(const void* plane, long long stride, long long R,
                     long long C, const void* k, long long k_val, void* cut,
                     void* list, void* stream) {
  const RankOut out = {nullptr, static_cast<long long*>(cut),
                       static_cast<long long*>(list)};
  return launch_rank_select<false, true>(plane, stride, R, C, k, k_val, out,
                                         stream);
}

int rt_take_and_cut(const void* plane, long long stride, long long R,
                    long long C, const void* k, long long k_val, void* take,
                    void* cut, void* list, void* stream) {
  const RankOut out = {static_cast<uint8_t*>(take),
                       static_cast<long long*>(cut),
                       static_cast<long long*>(list)};
  return launch_rank_select<true, true>(plane, stride, R, C, k, k_val, out,
                                        stream);
}

int rt_pack_rows(const void* plane, void* out, long long W, long long C,
                 long long nw_out, void* stream) {
  const long long total = W * nw_out;
  if (total > 0) {
    // a few blocks per SM, striding over the words
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (total + kThreads - 1) / kThreads;
    const unsigned blocks =
        static_cast<unsigned>(want < 4ll * sms ? want : 4ll * sms);
    pack_rows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(plane), static_cast<uint32_t*>(out), W, C,
        nw_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// plane: (R, C) bool rows ``stride`` bytes apart, each row's cells
// contiguous; counts: R int64.
int rt_popcount_rows(const void* plane, long long stride, long long R,
                     long long C, void* counts, void* stream) {
  if (R > 0 && C > 0) {
    const auto* p = static_cast<const uint8_t*>(plane);
    auto* out = static_cast<long long*>(counts);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C <= 32 * 32) {
      const long long per = R < kWarps ? R : kWarps;  // rows a block
      popcount_rows_kernel<true>
          <<<static_cast<unsigned>((R + per - 1) / per),
             static_cast<unsigned>(32 * per), 0, s>>>(p, stride, R, C, out);
    } else {
      popcount_rows_kernel<false>
          <<<static_cast<unsigned>(R), kThreads, 0, s>>>(p, stride, R, C,
                                                        out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// bounds: (2, n) int64, the sorted starts then the sorted ends; out: 4n
// int64.
int rt_coverage_multi(const void* bounds, long long n, void* out,
                      void* stream) {
  if (n > 0) {
    coverage_multi_kernel<<<static_cast<unsigned>((2 * n + kThreads - 1) /
                                                  kThreads),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(bounds), n,
        static_cast<long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// desc: a host array of 3R int64 -- the R plane pointers, the R geometry
// pointers, the R caps.  out: int64, R*W counts, the number of entries,
// then room for ``capacity`` entries.  ws: two uint32 counters on the
// card, zero.
int rt_phase_step(const long long* desc, const void* rowmask, void* out,
                  void* ws, long long R, long long W, long long capacity,
                  void* stream) {
  if (R > 0 && W > 0) {
    const size_t smem = 2 * static_cast<size_t>(W) * sizeof(int);
    if (smem > kDefaultDynamicSmem) {
      // past the default, opt in to Hopper's larger shared memory (up to
      // 227 KiB a block); a request the card cannot give is returned
      const cudaError_t e = cudaFuncSetAttribute(
          phase_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    for (long long r0 = 0; r0 < R; r0 += kMaxRegions) {
      const int n = static_cast<int>(R - r0 < kMaxRegions ? R - r0
                                                           : kMaxRegions);
      PhaseRegions regions = {};
      for (int i = 0; i < n; ++i) {
        regions.plane[i] = reinterpret_cast<const uint8_t*>(desc[r0 + i]);
        regions.geom[i] = reinterpret_cast<const int*>(desc[R + r0 + i]);
        regions.cap[i] = desc[2 * R + r0 + i];
      }
      const dim3 grid(static_cast<unsigned>(W), static_cast<unsigned>(n));
      phase_step_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
          regions, static_cast<int>(r0), static_cast<int>(W),
          static_cast<const uint8_t*>(rowmask), static_cast<long long*>(out),
          static_cast<unsigned*>(ws), R * W, capacity, r0 + n == R);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
