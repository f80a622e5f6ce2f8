// Page twin-diff kernels of the RegC consistency-region release, written
// for Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (ctypes; see ../_build.py and ../page_diff.py).
//
// Pages are (n, page_words) rows of fp32 words.  Both kernels treat a word
// as its 32-bit pattern and never run a float instruction on it: the diff
// has memcmp semantics (-0.0 against +0.0, NaN payloads and denormals
// under flush-to-zero are all real changes), and a value is copied as its
// bits.  The library is built without --use_fast_math, and nothing here
// would read it anyway.
//
// All are elementwise passes that read and write each word once with a
// handful of integer operations, so each is bound by memory traffic on
// the card (HBM3 at 3.35 TB/s): diff_encode moves 13 bytes a word (two
// 4-byte inputs, a 1-byte mask, a 4-byte value) plus 12 bytes of count
// and change bounds a page, the merges 13 bytes a word (three inputs of
// 4 + 1 + 4 bytes, a 4-byte output).  The design aims at one coalesced
// pass: 16-byte vector loads and stores (uint4 words, char4 mask bytes)
// whenever the row length and the pointers allow, and a scalar path
// otherwise.  At the
// protocol's shapes (one page of 256 or 1024 words per call) the launch
// itself is the real cost, so the engine merges in place where it
// overwrites the destination anyway: diff_apply_inplace writes only the
// words whose mask byte is set (and never reads the rest of dst), and
// diff_apply_rows does so for rows[i] of a home array, all rows in one
// launch, with no gather or scatter around it.
//
// Every C entry returns cudaGetLastError() so the Python wrapper can raise
// when a launch is refused.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// diff_apply's grid-stride loop needs no more blocks than keep every SM
// busy: 132 SMs times 16 resident blocks of 256 threads.
constexpr long long kMaxApplyBlocks = 132 * 16;

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) % to) == 0;
}

__device__ __forceinline__ int changed_word(uint32_t c, uint32_t t,
                                            int8_t* m, uint32_t* v) {
  const int d = c != t;
  *m = static_cast<int8_t>(d);
  *v = d ? c : 0u;  // +0.0 bits where unchanged
  return d;
}

// diff_encode: replaces _diff_encode_kernel / diff_encode
// (src/repro/kernels/page_diff.py:31, :54).  One block of 256 threads per
// page row (the TPU kernel tiled 8 pages per VMEM block and required
// n % 8 == 0; here any n >= 1 and any page_words run).  Each thread walks
// its words of the row (uint4 + char4 when kVec), writes the mask byte and
// the value bits, and keeps its count of changed words and the first and
// last of them; one block reduction (warp shuffles, then shared memory
// over the 8 warps) gives the row's count (sum), first changed word (min;
// page_words where none) and last (max; -1 where none), the release's
// change bounds, stored as stats[0][row], stats[1][row], stats[2][row].
template <bool kVec>
__global__ void diff_encode_kernel(const uint32_t* __restrict__ curr,
                                   const uint32_t* __restrict__ twin,
                                   int8_t* __restrict__ mask,
                                   uint32_t* __restrict__ vals,
                                   int* __restrict__ stats, long long pw) {
  const long long base = static_cast<long long>(blockIdx.x) * pw;
  const uint32_t* c = curr + base;
  const uint32_t* t = twin + base;
  int8_t* m = mask + base;
  uint32_t* v = vals + base;
  int n = 0;
  long long first = pw, last = -1;
  if (kVec) {
    const long long nv = pw / 4;
    const uint4* c4 = reinterpret_cast<const uint4*>(c);
    const uint4* t4 = reinterpret_cast<const uint4*>(t);
    char4* m4 = reinterpret_cast<char4*>(m);
    uint4* v4 = reinterpret_cast<uint4*>(v);
    for (long long i = threadIdx.x; i < nv; i += kThreads) {
      const uint4 a = c4[i];
      const uint4 b = t4[i];
      char4 mo;
      uint4 vo;
      int8_t mb;
      int d0, d1, d2, d3;
      d0 = changed_word(a.x, b.x, &mb, &vo.x);
      mo.x = mb;
      d1 = changed_word(a.y, b.y, &mb, &vo.y);
      mo.y = mb;
      d2 = changed_word(a.z, b.z, &mb, &vo.z);
      mo.z = mb;
      d3 = changed_word(a.w, b.w, &mb, &vo.w);
      mo.w = mb;
      m4[i] = mo;
      v4[i] = vo;
      const int any = d0 + d1 + d2 + d3;
      if (any) {
        n += any;
        const long long w0 = 4 * i;
        first = min(first, w0 + (d0 ? 0 : d1 ? 1 : d2 ? 2 : 3));
        last = w0 + (d3 ? 3 : d2 ? 2 : d1 ? 1 : 0);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < pw; i += kThreads) {
      if (changed_word(c[i], t[i], m + i, v + i)) {
        ++n;
        first = min(first, i);
        last = i;
      }
    }
  }
  __shared__ int partial[kWarps];
  __shared__ long long lo[kWarps], hi[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    n += __shfl_down_sync(kFull, n, o);
    first = min(first, __shfl_down_sync(kFull, first, o));
    last = max(last, __shfl_down_sync(kFull, last, o));
  }
  if ((threadIdx.x & 31) == 0) {
    partial[threadIdx.x >> 5] = n;
    lo[threadIdx.x >> 5] = first;
    hi[threadIdx.x >> 5] = last;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool in = threadIdx.x < kWarps;
    n = in ? partial[threadIdx.x] : 0;
    first = in ? lo[threadIdx.x] : pw;
    last = in ? hi[threadIdx.x] : -1;
    for (int o = 16; o > 0; o >>= 1) {
      n += __shfl_down_sync(kFull, n, o);
      first = min(first, __shfl_down_sync(kFull, first, o));
      last = max(last, __shfl_down_sync(kFull, last, o));
    }
    if (threadIdx.x == 0) {
      stats[blockIdx.x] = n;
      stats[gridDim.x + blockIdx.x] = static_cast<int>(first);
      stats[2 * gridDim.x + blockIdx.x] = static_cast<int>(last);
    }
  }
}

// diff_apply: replaces _diff_apply_kernel / diff_apply
// (src/repro/kernels/page_diff.py:43, :78): out = mask != 0 ? vals : dst,
// word by word over the flat (n * page_words) arrays (a row changes
// nothing in an elementwise select).  Any nonzero mask byte counts as set.
// A grid-stride loop over uint4/char4 groups when kVec, single words
// otherwise.
template <bool kVec>
__global__ void diff_apply_kernel(const uint32_t* __restrict__ dst,
                                  const int8_t* __restrict__ mask,
                                  const uint32_t* __restrict__ vals,
                                  uint32_t* __restrict__ out,
                                  long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (kVec) {
    const uint4* d4 = reinterpret_cast<const uint4*>(dst);
    const char4* m4 = reinterpret_cast<const char4*>(mask);
    const uint4* v4 = reinterpret_cast<const uint4*>(vals);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (const long long nv = total / 4; i < nv; i += stride) {
      const uint4 d = d4[i];
      const char4 m = m4[i];
      const uint4 v = v4[i];
      uint4 o;
      o.x = m.x ? v.x : d.x;
      o.y = m.y ? v.y : d.y;
      o.z = m.z ? v.z : d.z;
      o.w = m.w ? v.w : d.w;
      o4[i] = o;
    }
  } else {
    for (; i < total; i += stride) out[i] = mask[i] ? vals[i] : dst[i];
  }
}

// The in-place merge of one 16-byte group: the words whose mask byte is
// set take vals' bits; one uint4 store when all four are set.
__device__ __forceinline__ void merge4(uint4* d, char4 m, const uint4* v) {
  if (!(m.x | m.y | m.z | m.w)) return;
  const uint4 w = *v;
  if (m.x && m.y && m.z && m.w) {
    *d = w;
    return;
  }
  uint32_t* o = reinterpret_cast<uint32_t*>(d);
  if (m.x) o[0] = w.x;
  if (m.y) o[1] = w.y;
  if (m.z) o[2] = w.z;
  if (m.w) o[3] = w.w;
}

// diff_apply in place (the ordinary flush's merge onto its home page):
// dst = mask != 0 ? vals : dst over the flat array, dst read never.
template <bool kVec>
__global__ void diff_apply_inplace_kernel(uint32_t* __restrict__ dst,
                                          const int8_t* __restrict__ mask,
                                          const uint32_t* __restrict__ vals,
                                          long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (kVec) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const char4* m4 = reinterpret_cast<const char4*>(mask);
    const uint4* v4 = reinterpret_cast<const uint4*>(vals);
    for (const long long nv = total / 4; i < nv; i += stride)
      merge4(d4 + i, m4[i], v4 + i);
  } else {
    for (; i < total; i += stride)
      if (mask[i]) dst[i] = vals[i];
  }
}

// diff_apply in place on rows[r] of home (the fine release's merge of its
// span's pages): block b merges words [c * 4 * kThreads, ...) of row
// r = b / chunks, home[rows[r]] = mask[r] != 0 ? vals[r] : home[rows[r]].
// rows must be sorted, unique and within home (no two blocks write one
// word): a row out of range or out of order stops the kernel with a trap
// (a device-side fault, like an index assert) instead of writing
// elsewhere.
template <bool kVec>
__global__ void diff_apply_rows_kernel(uint32_t* __restrict__ home,
                                       const long long* __restrict__ rows,
                                       const int8_t* __restrict__ mask,
                                       const uint32_t* __restrict__ vals,
                                       long long n, long long pw,
                                       long long chunks, long long n_home) {
  const long long r = blockIdx.x / chunks;
  const long long c = blockIdx.x % chunks;
  const long long row = rows[r];
  if (row < 0 || row >= n_home || (r + 1 < n && rows[r + 1] <= row))
    __trap();
  uint32_t* h = home + row * pw;
  const int8_t* m = mask + r * pw;
  const uint32_t* v = vals + r * pw;
  if (kVec) {
    const long long i = c * kThreads + threadIdx.x;
    if (i < pw / 4)
      merge4(reinterpret_cast<uint4*>(h) + i,
             reinterpret_cast<const char4*>(m)[i],
             reinterpret_cast<const uint4*>(v) + i);
  } else {
    const long long i = c * kThreads + threadIdx.x;
    if (i < pw && m[i]) h[i] = v[i];
  }
}

}  // namespace

extern "C" {

// curr, twin (n, pw) float32, mask (n, pw) int8, vals (n, pw) float32 and
// stats (3, n) int32 (count, first, last), all contiguous; pw < 2^31.
int rt_diff_encode(const void* curr, const void* twin, void* mask, void* vals,
                   void* stats, long long n, long long pw, void* stream) {
  if (n > 0) {
    const bool vec = pw % 4 == 0 && aligned(curr, 16) && aligned(twin, 16) &&
                     aligned(vals, 16) && aligned(mask, 4);
    const auto* c = static_cast<const uint32_t*>(curr);
    const auto* t = static_cast<const uint32_t*>(twin);
    auto* m = static_cast<int8_t*>(mask);
    auto* v = static_cast<uint32_t*>(vals);
    auto* k = static_cast<int*>(stats);
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(n);
    if (vec) {
      diff_encode_kernel<true><<<grid, kThreads, 0, s>>>(c, t, m, v, k, pw);
    } else {
      diff_encode_kernel<false><<<grid, kThreads, 0, s>>>(c, t, m, v, k, pw);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_diff_apply(const void* dst, const void* mask, const void* vals,
                  void* out, long long total, void* stream) {
  if (total > 0) {
    const bool vec = total % 4 == 0 && aligned(dst, 16) &&
                     aligned(vals, 16) && aligned(out, 16) &&
                     aligned(mask, 4);
    const long long items = vec ? total / 4 : total;
    long long blocks = (items + kThreads - 1) / kThreads;
    if (blocks > kMaxApplyBlocks) blocks = kMaxApplyBlocks;
    const auto* d = static_cast<const uint32_t*>(dst);
    const auto* m = static_cast<const int8_t*>(mask);
    const auto* v = static_cast<const uint32_t*>(vals);
    auto* o = static_cast<uint32_t*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(blocks);
    if (vec) {
      diff_apply_kernel<true><<<grid, kThreads, 0, s>>>(d, m, v, o, total);
    } else {
      diff_apply_kernel<false><<<grid, kThreads, 0, s>>>(d, m, v, o, total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_diff_apply_(void* dst, const void* mask, const void* vals,
                   long long total, void* stream) {
  if (total > 0) {
    const bool vec = total % 4 == 0 && aligned(dst, 16) &&
                     aligned(vals, 16) && aligned(mask, 4);
    const long long items = vec ? total / 4 : total;
    long long blocks = (items + kThreads - 1) / kThreads;
    if (blocks > kMaxApplyBlocks) blocks = kMaxApplyBlocks;
    auto* d = static_cast<uint32_t*>(dst);
    const auto* m = static_cast<const int8_t*>(mask);
    const auto* v = static_cast<const uint32_t*>(vals);
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(blocks);
    if (vec) {
      diff_apply_inplace_kernel<true><<<grid, kThreads, 0, s>>>(d, m, v,
                                                                total);
    } else {
      diff_apply_inplace_kernel<false><<<grid, kThreads, 0, s>>>(d, m, v,
                                                                 total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// home (n_home, pw) float32, rows (n,) int64, mask (n, pw) int8 and vals
// (n, pw) float32, all contiguous.
int rt_diff_apply_rows_(void* home, const void* rows, const void* mask,
                        const void* vals, long long n, long long pw,
                        long long n_home, void* stream) {
  if (n > 0 && pw > 0) {
    const bool vec = pw % 4 == 0 && aligned(home, 16) && aligned(vals, 16) &&
                     aligned(mask, 4);
    const long long items = vec ? pw / 4 : pw;
    const long long chunks = (items + kThreads - 1) / kThreads;
    if (n * chunks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    auto* h = static_cast<uint32_t*>(home);
    const auto* r = static_cast<const long long*>(rows);
    const auto* m = static_cast<const int8_t*>(mask);
    const auto* v = static_cast<const uint32_t*>(vals);
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(n * chunks);
    if (vec) {
      diff_apply_rows_kernel<true><<<grid, kThreads, 0, s>>>(
          h, r, m, v, n, pw, chunks, n_home);
    } else {
      diff_apply_rows_kernel<false><<<grid, kThreads, 0, s>>>(
          h, r, m, v, n, pw, chunks, n_home);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
