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
// Both are elementwise passes that read and write each word once with a
// handful of integer operations, so each is bound by memory traffic on
// the card (HBM3 at 3.35 TB/s): diff_encode moves 13 bytes a word (two
// 4-byte inputs, a 1-byte mask, a 4-byte value) plus 4 bytes of count a
// page, diff_apply 13 bytes a word (three inputs of 4 + 1 + 4 bytes, a
// 4-byte output).  The design aims at one coalesced pass: 16-byte vector
// loads and stores (uint4 words, char4 mask bytes) whenever the row
// length and the pointers allow, and a scalar path otherwise.  At the
// protocol's shapes (one page of 256 or 1024 words per call) the launch
// itself is the real cost.
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
// the value bits, and counts its changed words; a warp shuffle sum, a
// shared-memory sum over the 8 warps, and one int32 store per row.
template <bool kVec>
__global__ void diff_encode_kernel(const uint32_t* __restrict__ curr,
                                   const uint32_t* __restrict__ twin,
                                   int8_t* __restrict__ mask,
                                   uint32_t* __restrict__ vals,
                                   int* __restrict__ count, long long pw) {
  const long long base = static_cast<long long>(blockIdx.x) * pw;
  const uint32_t* c = curr + base;
  const uint32_t* t = twin + base;
  int8_t* m = mask + base;
  uint32_t* v = vals + base;
  int n = 0;
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
      n += changed_word(a.x, b.x, &mb, &vo.x);
      mo.x = mb;
      n += changed_word(a.y, b.y, &mb, &vo.y);
      mo.y = mb;
      n += changed_word(a.z, b.z, &mb, &vo.z);
      mo.z = mb;
      n += changed_word(a.w, b.w, &mb, &vo.w);
      mo.w = mb;
      m4[i] = mo;
      v4[i] = vo;
    }
  } else {
    for (long long i = threadIdx.x; i < pw; i += kThreads) {
      n += changed_word(c[i], t[i], m + i, v + i);
    }
  }
  __shared__ int partial[kWarps];
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(kFull, n, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x < 32) {
    n = threadIdx.x < kWarps ? partial[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(kFull, n, o);
    if (threadIdx.x == 0) count[blockIdx.x] = n;
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

}  // namespace

extern "C" {

int rt_diff_encode(const void* curr, const void* twin, void* mask, void* vals,
                   void* count, long long n, long long pw, void* stream) {
  if (n > 0) {
    const bool vec = pw % 4 == 0 && aligned(curr, 16) && aligned(twin, 16) &&
                     aligned(vals, 16) && aligned(mask, 4);
    const auto* c = static_cast<const uint32_t*>(curr);
    const auto* t = static_cast<const uint32_t*>(twin);
    auto* m = static_cast<int8_t*>(mask);
    auto* v = static_cast<uint32_t*>(vals);
    auto* k = static_cast<int*>(count);
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

}  // extern "C"
