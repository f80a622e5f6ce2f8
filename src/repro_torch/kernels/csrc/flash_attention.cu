// Causal GQA flash attention of the model path's prefill, written for
// Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (ctypes; see ../_build.py and ../flash_attention.py).
//
// Replaces _flash_kernel / flash_attention
// (src/repro/kernels/flash_attention.py:22, :79): for q (B, Hq, S, D) and
// k, v (B, Hkv, S, D), o = softmax(mask(softcap(q k^T * scale))) v with
// f32 accumulation, query head h reading KV head h / (Hq / Hkv) (GQA and
// MQA with no KV repeat in memory), a causal mask, an optional sliding
// window and an optional tanh logit softcap.
//
// What bounds it on this card.  It does 4 * D flops per unmasked (query,
// key) pair and reads each operand once.  Both products run on the
// tensor cores:
//   * bfloat16: mma.sync m16n8k16 with bf16 operands and f32 sums.  At
//     the internlm2-1.8b prefill shape (B = 4, Hq = 16, Hkv = 8, S = 512,
//     D = 128; 4.30 GFLOP over the causal pairs, 25.2 MB) the least time
//     is the bytes, 7.51 us at 3.35 TB/s (the flops take 4.35 us at 989
//     TFLOP/s);
//   * float32: each product as three TF32 products of split operands
//     (split_tf32.cuh: lo*hi + hi*lo + hi*hi, f32 accuracy), so the
//     flops run at a third of the 495 TFLOP/s TF32 peak: 26.08 us at the
//     same shape, against 15.02 us of bytes.  The CUDA-core kernel this
//     one replaces could not pass 64.23 us (67 TFLOP/s).
//
// Design (FlashAttention-2's, for mma.sync).  The TPU kernel walks the
// KV blocks as the innermost grid axis and carries m, l and acc in VMEM
// scratch; a Hopper block cannot carry state across grid steps, so one
// block owns the query rows of one (b, h) and loops over the KV tiles
// itself: bf16 4 warps, 64 rows and 64-key tiles; f32 8 warps, 128 rows
// and 32-key tiles (its split Q takes 128 KiB of shared memory; 8 warps
// sharing each tile ran faster on the card than 4 warps on 64-key tiles,
// which spilled at D = 128).
//   * each warp owns 16 query rows: its score tile and its output
//     accumulator (16 x D) live in registers as mma C fragments, m and l
//     per row too (l summed per thread, the 4 threads of a row added at
//     the end);
//   * bf16: the warp's Q fragments are loaded once into registers; K is
//     the col-major B operand of Q.K^T (ldmatrix), V that of P.V
//     (ldmatrix.trans); the score accumulator packs straight into the A
//     fragment of P.V (FlashAttention-2's register reuse), so P never
//     touches shared memory.  The TPU kernel rounds P to bf16 once before
//     P.V (p.astype(v.dtype)); rounded once, P misses the card's check
//     against the plain version (rtol 8e-3 / atol 2e-3) by a bf16 ulp
//     where a row sees only a few keys (window 3: 7.8e-3 at values below
//     0.73), so P goes in as two bf16 terms, hi = bf16(p) and
//     lo = bf16(p - hi), two products that keep p to 16 bits; l sums the
//     unrounded p.  KV tiles are double-buffered with cp.async, so the
//     next tile's copy overlaps this one's products;
//   * f32: every product is three TF32 products (split_tf32.cuh).  Q is
//     split into TF32 (hi, lo) once per block and kept in shared memory
//     in fragment order, so a warp's A fragments are two 16-byte loads
//     per k step (split in registers Q would take 128 registers a thread
//     at D = 128).  Each K and V tile is copied raw by cp.async and split
//     once per block, in fragment order, into (hi, lo) tiles (one 16-byte
//     load per B fragment pair); the next raw tile's copy overlaps the
//     products of the split ones.  The m16n8k8 C fragment (row g: columns
//     2t, 2t+1) does not match its A fragment (row g: columns t, t+4), and
//     P needs neither a warp shuffle nor a trip through shared memory: a
//     product sums over k in any order, so each k step of 8 takes its
//     operands' columns in the order (0, 2, 4, 6, 1, 3, 5, 7): column 2t
//     is the fragment's k = t and 2t + 1 its k = t + 4.  P's A fragment is
//     then the score accumulator's own registers, split in place;
//   * an operand whose base or strides are not 16-byte aligned is copied
//     element by element instead of by cp.async (never refused);
//   * only the live KV tiles are visited (the TPU kernel's skip of fully
//     masked tiles, :36-41), and only the diagonal, window-edge and ragged
//     tiles are masked element by element;
//   * the order of operations is the reference's: s = q.k * scale, then
//     softcap * tanh(s / softcap), then the mask to -1e30, then the online
//     softmax (exp(s - m) taken as exp2((s - m) log2 e)); the final divide
//     is by max(l, 1e-30);
//   * balance: causal query tiles differ in work by up to S / 64 times,
//     so the grid's y axis runs the longest tiles first;
//   * any S >= 1: rows and keys past S are zero filled and masked;
//   * operands are read through (b, h, s) strides with a unit d stride,
//     so the model's (B, S, H, D) activations need no transpose; the
//     output, the wrapper's own (B, S, Hq, D) tensor, is written through
//     strides too, two words at a time.
// Shared memory at D = 128: f32 230,912 bytes (split Q 131,072, one raw
// K and V tile 34,304, split K and V 65,536), bf16 69,632; over the
// 48 KiB default, so each instantiation opts in once.
//
// The C entry returns cudaGetLastError() so the Python wrapper can raise
// when a launch is refused.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "split_tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;  // element strides; the d stride is 1
};

// Tile shapes and shared-memory layout of one instantiation.
template <typename T, int D>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  // f32: 8 warps share each (split-Q-limited) block's K and V tiles
  static constexpr int kWarps = kF32 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;  // query rows of a block
  static constexpr int kBK = kF32 ? 32 : 64;  // keys of a KV tile
  static constexpr int kNJ = kBK / 8;      // score n-tiles of a warp
  static constexpr int kNO = D / 8;        // output n-tiles of a warp
  // Row strides of the raw tiles in elements, padded so the loads of
  // fragment words are free of bank conflicts: the f32 split pass takes K
  // in 8-byte loads at (row g, word 2t) and V in 4-byte loads at (row 2t,
  // word g); bf16 K and V are ldmatrix rows.
  static constexpr int kKLD = D + 8;
  static constexpr int kVLD = kF32 ? D + 4 : D + 8;
  // f32 split Q in fragment order: (warp, k step, lane) -> one uint4 of
  // hi and, kQLo uint4 further on, one of lo
  static constexpr int kQLo = kBQ * D / 4;
  static constexpr int kQBytes = kF32 ? 2 * kQLo * 16 : 0;
  static constexpr int kKBytes = kBK * kKLD * static_cast<int>(sizeof(T));
  static constexpr int kVBytes = kBK * kVLD * static_cast<int>(sizeof(T));
  // raw K and V tiles: bf16 double-buffered; f32 single, its copy
  // overlapping the products of the split tiles below
  static constexpr int kStages = kF32 ? 1 : 2;
  // f32 K and V tiles split into TF32 in fragment order, once per block:
  // (k step, n tile, lane) -> one uint4 {hi b0, hi b1, lo b0, lo b1}
  static constexpr int kSplitBytes = kF32 ? kBK * D * 8 : 0;
  static constexpr int kSmem =
      kQBytes + kStages * (kKBytes + kVBytes) + 2 * kSplitBytes;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a * b, one m16n8k16 bf16 product with f32 sums.  Fragments
// (g = lane / 4, t = lane % 4), two bf16 a register, the lower column
// first: a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}; d as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix4_trans(uint32_t (&r)[4],
                                                const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// Keys k0 .. k0 + kBK - 1 of one K or V head into dst (row stride LD),
// zero past S: 16-byte cp.async pieces when the operand allows them
// (completing at the next wait), else element by element at once.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_tile(T* dst, const T* src,
                                           long long ld, int k0, int S,
                                           bool vec) {
  using L = Tile<T, D>;
  if (vec) {
    constexpr int V = 16 / sizeof(T);  // elements of a piece
    constexpr int CH = D / V;
    constexpr int pieces = L::kBK * CH;
#pragma unroll
    for (int k = 0; k < (pieces + L::kThreads - 1) / L::kThreads; ++k) {
      const int e = threadIdx.x + k * L::kThreads;
      if (pieces % L::kThreads != 0 && e >= pieces) break;
      const int r = e / CH, c = (e % CH) * V;
      const bool ok = k0 + r < S;
      cp_async16(dst + r * LD + c,
                 src + (ok ? (k0 + r) * ld : 0) + c, ok);
    }
  } else {
    for (int e = threadIdx.x; e < L::kBK * D; e += L::kThreads) {
      const int r = e / D, c = e % D;
      dst[r * LD + c] = k0 + r < S ? src[(k0 + r) * ld + c] : zero<T>();
    }
  }
}

// The f32 K and V tiles (row strides kKLD, kVLD) split into TF32 in the
// fragment order of the products, each word once per block: KS item
// (c, j, lane) holds key 8j + g's words 8c + 2t and 8c + 2t + 1 (Q.K^T's
// b0 and b1), VS item (J, n, lane) word 8n + g of keys 8J + 2t and
// 8J + 2t + 1 (P.V's).
template <int D>
__device__ __forceinline__ void split_tiles(uint4* KS, uint4* VS,
                                            const float* Kr,
                                            const float* Vr) {
  using L = Tile<float, D>;
  constexpr int items = L::kBK * D / 2;
  static_assert(items % L::kThreads == 0, "whole items per thread");
#pragma unroll
  for (int k = 0; k < items / L::kThreads; ++k) {
    const int e = threadIdx.x + k * L::kThreads;
    const int ll = e % 32, g = ll / 4, t = ll % 4;
    {  // K: e = (c * kNJ + j) * 32 + lane
      const int j = e / 32 % L::kNJ, c = e / (32 * L::kNJ);
      const float2 x = *reinterpret_cast<const float2*>(
          Kr + (8 * j + g) * L::kKLD + 8 * c + 2 * t);
      uint32_t h0, l0, h1, l1;
      split(x.x, h0, l0);
      split(x.y, h1, l1);
      KS[e] = make_uint4(h0, h1, l0, l1);
    }
    {  // V: e = (J * kNO + n) * 32 + lane
      const int n = e / 32 % L::kNO, J = e / (32 * L::kNO);
      const float* p = Vr + (8 * J + 2 * t) * L::kVLD + 8 * n + g;
      uint32_t h0, l0, h1, l1;
      split(p[0], h0, l0);
      split(p[L::kVLD], h1, l1);
      VS[e] = make_uint4(h0, h1, l0, l1);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides sq,
             Strides sk, Strides sv, Strides so, int Hq, int group, int S,
             float scale, int causal, int window, float softcap, int vec_k,
             int vec_v) {
  using L = Tile<T, D>;
  constexpr int BQ = L::kBQ, BK = L::kBK, NJ = L::kNJ, NO = L::kNO;
  extern __shared__ uint4 smem[];
  uint4* Qs = smem;  // f32 only: split Q
  T* Ks = reinterpret_cast<T*>(reinterpret_cast<char*>(smem) + L::kQBytes);
  T* Vs = reinterpret_cast<T*>(reinterpret_cast<char*>(Ks) +
                               L::kStages * L::kKBytes);
  // f32 only: the split K and V tiles
  uint4* KS = reinterpret_cast<uint4*>(reinterpret_cast<char*>(Vs) +
                                       L::kStages * L::kVBytes);
  uint4* VS = KS + L::kSplitBytes / 16;

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / group;
  const int nq = (S + BQ - 1) / BQ;
  // the longest causal tiles first
  const int q0 = (causal ? nq - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;
  const int r0 = q0 + 16 * w + g;  // this thread's rows: r0 and r0 + 8

  // the live KV tiles: [kt0, kt1)
  const int nk = (S + BK - 1) / BK;
  int kt0 = 0, kt1 = nk;
  if (causal) kt1 = min(nk, (q0 + BQ - 1) / BK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt0 = (q0 - window + 1) / BK;

  stage_tile<T, D, L::kKLD>(Ks, kb, sk.s, kt0 * BK, S, vec_k);
  stage_tile<T, D, L::kVLD>(Vs, vb, sv.s, kt0 * BK, S, vec_v);
  cp_commit();

  // Q: bf16 fragments in registers; f32 split into shared memory
  uint32_t qa[L::kF32 ? 1 : D / 16][4];
  if constexpr (L::kF32) {
    // item e = (warp ww, k step c, lane ll): the A fragment of rows
    // q0 + 16 ww + (ll / 4) (+ 8), columns 8c + 2 (ll % 4) (+ 1)
    for (int e = threadIdx.x; e < L::kQLo; e += L::kThreads) {
      const int ll = e % 32, c = e / 32 % (D / 8), ww = e / (4 * D);
      const int s = q0 + 16 * ww + ll / 4, d = 8 * c + 2 * (ll % 4);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (s < S) {
        a[0] = qb[s * sq.s + d];
        a[2] = qb[s * sq.s + d + 1];
      }
      if (s + 8 < S) {
        a[1] = qb[(s + 8) * sq.s + d];
        a[3] = qb[(s + 8) * sq.s + d + 1];
      }
      const FragA f = split_a(a);
      Qs[e] = make_uint4(f.h[0], f.h[1], f.h[2], f.h[3]);
      Qs[L::kQLo + e] = make_uint4(f.l[0], f.l[1], f.l[2], f.l[3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = r0 + 8 * i;
        const T* p = qb + s * sq.s + 16 * c + 2 * t;
        const bool ok = s < S;
        qa[c][i] = ok ? pack_bf16(p[0], p[1]) : 0u;
        qa[c][i + 2] = ok ? pack_bf16(p[8], p[9]) : 0u;
      }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    const T* Kt = Ks;
    const T* Vt = Vs;
    if constexpr (L::kF32) {
      cp_wait<0>();
      __syncthreads();  // tile kt is in; every warp is done with KS, VS
      split_tiles<D>(KS, VS, reinterpret_cast<const float*>(Ks),
                     reinterpret_cast<const float*>(Vs));
      __syncthreads();  // the split tiles are in; Ks and Vs are free
      if (kt + 1 < kt1) {
        stage_tile<T, D, L::kKLD>(Ks, kb, sk.s, k0 + BK, S, vec_k);
        stage_tile<T, D, L::kVLD>(Vs, vb, sv.s, k0 + BK, S, vec_v);
        cp_commit();
      }
    } else {
      const int buf = (kt - kt0) & 1;
      if (kt + 1 < kt1) {
        stage_tile<T, D, L::kKLD>(Ks + (buf ^ 1) * BK * L::kKLD, kb, sk.s,
                                  k0 + BK, S, vec_k);
        stage_tile<T, D, L::kVLD>(Vs + (buf ^ 1) * BK * L::kVLD, vb, sv.s,
                                  k0 + BK, S, vec_v);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      Kt += buf * BK * L::kKLD;
      Vt += buf * BK * L::kVLD;
    }

    // ---- s = q . k^T (16 x BK per warp) ----
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    if constexpr (L::kF32) {
      const uint4* qw = Qs + w * (4 * D) + lane;
      const uint4* kf = KS + lane;
#pragma unroll 2
      for (int c = 0; c < D / 8; ++c) {
        const uint4 qh = qw[32 * c], ql = qw[L::kQLo + 32 * c];
        const uint32_t ah[4] = {qh.x, qh.y, qh.z, qh.w};
        const uint32_t al[4] = {ql.x, ql.y, ql.z, ql.w};
        uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint4 kv = kf[(c * NJ + j) * 32];
          bh[j][0] = kv.x;
          bh[j][1] = kv.y;
          bl[j][0] = kv.z;
          bl[j][1] = kv.w;
        }
        // product-major, so the dependent mmas into one tile are NJ apart
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma(sc[j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma(sc[j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma(sc[j], ah, bh[j]);
      }
    } else {
      // matrix mi = lane / 8 of an x4 load: keys + 8 (mi >> 1), d + 8 (mi & 1)
      const T* kw = Kt + (((lane >> 4) << 3) + (lane & 7)) * L::kKLD +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          uint32_t r[4];
          ldmatrix4(r, kw + 16 * jj * L::kKLD + 16 * c);
          mma_bf16(sc[2 * jj], qa[c], r[0], r[1]);
          mma_bf16(sc[2 * jj + 1], qa[c], r[2], r[3]);
        }
    }

    // ---- scale, softcap, mask, online softmax ----
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int qp = r0 + 8 * (e >> 1), kp = k0 + 8 * j + 2 * t + (e & 1);
          bool keep = kp < S;
          if (causal) keep = keep && qp >= kp;
          if (window > 0) keep = keep && qp - kp < window;
          x = keep ? x : kNegInf;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // exp(x - m) as exp2((x - m) log2(e)); x - m is 0 where both are the
    // mask's -1e30 (x log2(e) - m log2(e) in one FFMA is not: it keeps the
    // product's rounding, ~1e23 there)
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sc[j][e] - m[e >> 1]) * kLog2e);
        sc[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // ---- acc += p . v ----
    if constexpr (L::kF32) {
      // key k step J takes keys 8J + 2t (k = t) and 8J + 2t + 1 (k = t + 4)
      const uint4* vf = VS + lane;
      // output tiles whose B fragments are held at once
      constexpr int G = NO < 4 ? NO : 4;
#pragma unroll
      for (int J = 0; J < NJ; ++J) {
        const float pa[4] = {sc[J][0], sc[J][2], sc[J][1], sc[J][3]};
        const FragA fa = split_a(pa);
#pragma unroll
        for (int n0 = 0; n0 < NO; n0 += G) {
          uint32_t bh[G][2], bl[G][2];
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const uint4 vv = vf[(J * NO + n0 + i) * 32];
            bh[i][0] = vv.x;
            bh[i][1] = vv.y;
            bl[i][0] = vv.z;
            bl[i][1] = vv.w;
          }
#pragma unroll
          for (int i = 0; i < G; ++i) mma(acc[n0 + i], fa.l, bh[i]);
#pragma unroll
          for (int i = 0; i < G; ++i) mma(acc[n0 + i], fa.h, bl[i]);
#pragma unroll
          for (int i = 0; i < G; ++i) mma(acc[n0 + i], fa.h, bh[i]);
        }
      }
    } else {
      // matrix mi = lane / 8 of an x4.trans load: keys + 8 (mi & 1),
      // d + 8 (mi >> 1)
      const T* vw = Vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * L::kVLD +
                    (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        // p = hi + lo, both bf16: two products keep p to 16 bits
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* pp = sc[2 * kk + i / 2] + 2 * (i % 2);
          ph[i] = pack_bf16(pp[0], pp[1]);
          pl[i] = pack_bf16(pp[0] - __uint_as_float(ph[i] << 16),
                            pp[1] - __uint_as_float(ph[i] & 0xffff0000u));
        }
#pragma unroll
        for (int nn = 0; nn < NO / 2; ++nn) {
          uint32_t r[4];
          ldmatrix4_trans(r, vw + 16 * kk * L::kVLD + 16 * nn);
          mma_bf16(acc[2 * nn], pl, r[0], r[1]);
          mma_bf16(acc[2 * nn + 1], pl, r[2], r[3]);
          mma_bf16(acc[2 * nn], ph, r[0], r[1]);
          mma_bf16(acc[2 * nn + 1], ph, r[2], r[3]);
        }
      }
    }
    if constexpr (!L::kF32) __syncthreads();  // done with this buffer
  }

  // ---- o = acc / max(l, 1e-30) ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int s = r0 + 8 * i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* os = ob + s * so.s + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = acc[n][2 * i] / den, x1 = acc[n][2 * i + 1] / den;
      if constexpr (L::kF32)
        *reinterpret_cast<float2*>(os + 8 * n) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(os + 8 * n) = pack_bf16(x0, x1);
    }
  }
}

// every row of the operand starts on 16 bytes: cp.async pieces can copy it
bool aligned16(const void* base, const Strides& st, long long elem) {
  const long long v = 16 / elem;  // elements of 16 bytes
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && st.b % v == 0 &&
         st.h % v == 0 && st.s % v == 0;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           long long B, long long Hq, long long Hkv, long long S,
           Strides sq, Strides sk, Strides sv, Strides so, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  using L = Tile<T, D>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((S + L::kBQ - 1) / L::kBQ));
  const int vec_k = aligned16(k, sk, sizeof(T));
  const int vec_v = aligned16(v, sv, sizeof(T));
  flash_kernel<T, D><<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so,
      static_cast<int>(Hq), static_cast<int>(Hq / Hkv),
      static_cast<int>(S), scale, causal, window, softcap, vec_k, vec_v);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(long long D, const void* q, const void* k, const void* v,
               void* o, long long B, long long Hq, long long Hkv,
               long long S, Strides sq, Strides sk, Strides sv, Strides so,
               float scale, int causal, int window, float softcap,
               cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, sq, sk, sv, so,
                                  scale, causal, window, softcap, st);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, sq, sk, sv, so,
                                  scale, causal, window, softcap, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, sq, sk, sv, so,
                                  scale, causal, window, softcap, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, sq, sk, sv,
                                    so, scale, causal, window, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements, three per
// operand (b, h, s); the d stride must be 1.  o must be the wrapper's
// (B, S, Hq, D) allocation (8-byte aligned rows).  window <= 0 and
// softcap <= 0 switch those off.
extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    long long B, long long Hq, long long Hkv, long long S, long long D,
    long long qb, long long qh, long long qs, long long kb, long long kh,
    long long ks, long long vb, long long vh, long long vs, long long ob,
    long long oh, long long os, float scale, int causal, int window,
    float softcap, void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs},
      so{ob, oh, os};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, S, sq, sk, sv, so,
                             scale, causal, window, softcap, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, S, sq, sk,
                                     sv, so, scale, causal, window, softcap,
                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}
