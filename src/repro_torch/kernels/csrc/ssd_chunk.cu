// Mamba-2 SSD intra-chunk block of the model path's prefill, written for
// Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (ctypes; see ../_build.py and ../ssd_chunk.py).
//
// Replaces _ssd_chunk_kernel / ssd_chunk
// (src/repro/kernels/ssd_chunk.py:26, :52).  For each cell m (one batch
// row, chunk and head) with chunk length Q, head dim P, state dim N and
// B/C row g = m / rep:
//   y[i]  = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   state = sum_j (x_j * exp(cum_{Q-1} - cum_j) * dt_j) (outer) B_j
// with x, B, C in f32 or bf16, dt and cum in f32, and f32 outputs
// y (M, Q, P) and state (M, P, N).
//
// What bounds it on this card.  The function needs C.B^T over the
// Q(Q+1)/2 causal pairs (2N flops each) once per B/C group, and per cell
// Q(Q+1)/2 * 2P flops for the scores times x and 2QPN for the state: at
// mamba2-2.7b (M = 640, Q = 256, P = 64, N = 128, rep = 80) 5.45 GFLOP
// against 108 MB, so operations bound it.  The products must keep f32
// accuracy (TF32 stays off on the model path; one TF32 product misses
// the 1e-4 check), so each runs on the tensor cores as three TF32
// products of split operands, a = hi + lo with hi = tf32(a) and
// lo = tf32(a - hi): lo*hi + hi*lo + hi*hi with f32 accumulation
// (mma.sync m16n8k8 .tf32; the split and the products are
// split_tf32.cuh's, shared with flash_attention.cu).  The least time is
// then the work at a third of the 495 TFLOP/s TF32 peak, 165 TFLOP/s:
// 33.0 us for the grouped mamba2 call (bytes 32.3 us), and 81.8 us of
// bytes for the per-cell layout (rep = 1, 10.8 GFLOP: 65.3 us).
//
// Design.
//   * C.B^T once per (B/C row g, 64-row query stripe, slice of heads): a
//     y block forms the stripe's causal C.B^T (64 x up to 256 keys, f32)
//     in shared memory, then loops over its slice of the group's heads;
//     for each head it scales the shared tile by that head's decay and dt
//     while forming the mma A fragments, and multiplies it with the
//     head's x.  The mask is applied BEFORE the exp, as the reference
//     does (ssd_chunk.py:36-40): above the diagonal the exponent is -inf,
//     so exp gives 0 and never overflows to inf, and the C.B^T entry there
//     (not formed) is selected away.  At mamba2-2.7b a group's 80 heads
//     share one B/C row, and C.B^T is formed once per slice of 10 heads
//     instead of once per head.
//   * The state: a state block owns (g, 64 state columns, slice of
//     heads), holds that B chunk (up to 256 rows) in shared memory and
//     reuses it across its heads: state_h += (x_h o w_h)^T . B, with
//     w_j = exp(cum_{Q-1} - cum_j) dt_j.  No block walks all Q rows for
//     all P*N outputs of a cell any more.
//   * Balance: the causal triangle makes query stripe t cost t + 1 key
//     tiles, so a y block takes the stripe pair (t, nt - 1 - t); the
//     state blocks come first in the grid.  The head slices are chosen
//     for the fewest waves of blocks times heads a block.
//   * cp.async keeps up to three key tiles loading (two at P = 128) while
//     one is multiplied: the B tiles of C.B^T, and the x tiles with their
//     cum and dt.  bf16 operands are widened on the way in, with plain
//     loads.  Each staged x tile (times w_j for the state) is split into
//     TF32 (hi, lo) pairs once, by all threads, so the warps' fragment
//     loads are 8-byte loads with no conversion; the decayed C.B^T
//     entries are split as each warp forms its A fragment.
//   * 512 threads, 16 warps, to hide the latency of the mma chains and
//     of the split passes, which bound a block more than its issue rate:
//     in a y block warps 0-7 take the even heads of the slice and warps 8-15
//     the odd ones, warp w query rows 16 (w % 4) .. +16 and half the P
//     columns.  Each decayed C.B^T entry (with the fast exp, __expf: its
//     error, about 1e-6 relative where the decay matters, is far inside
//     the 1e-4 check) serves P / 16 products.  The three products go
//     product-major over a warp's column tiles so that the dependent
//     mmas into one accumulator are several mmas apart.  Loop counters,
//     compile-time shapes and per-warp base pointers keep the address
//     arithmetic out of the inner loops.  Shared-memory row strides are
//     padded so the fragment loads are free of bank conflicts.
//   * Any Q >= 1: rows past Q are zero filled and never stored; for
//     Q > 256 the keys go in chunks of 256, y and the state accumulating
//     in place over the chunks.
// Shared memory at P = 64, N = 128 is 177,280 bytes (at most 204,864, at
// P = 128), over the 48 KiB default, so the kernel opts in (once per
// instantiation); one block runs on an SM.
//
// The C entry returns cudaGetLastError() so the Python wrapper can raise
// when a launch is refused.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "split_tf32.cuh"

namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // query rows of a stripe
constexpr int kKT = 32;        // key rows of a staged tile
constexpr int kChunk = 256;    // keys of C.B^T (or rows of B) held at once

// dst[r][c] = src[(row0 + r) * src_ld + col0 + c] (as f32) for r < ROWS,
// c < COLS (a multiple of 16), 0 where row0 + r >= limit.  float goes by
// cp.async (completes at the next wait); bf16 is loaded, widened and
// stored at once.  ROWS and COLS are compile-time, so each thread's
// pieces are a fixed, unrolled set of offsets from one row pointer.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           int src_ld, int row0, int limit,
                                           int col0) {
  constexpr int V = sizeof(T) == 4 ? 4 : 8;  // elements per 16 bytes
  constexpr int groups = COLS / V, pieces = ROWS * groups;
  const T* base = src + static_cast<long long>(row0) * src_ld + col0;
#pragma unroll
  for (int k = 0; k < (pieces + kThreads - 1) / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (pieces % kThreads != 0 && e >= pieces) break;
    const int r = e / groups, c = (e % groups) * V;
    const bool ok = row0 + r < limit;
    const T* g = base + (ok ? r * src_ld : -row0 * src_ld) + c;
    float* s = dst + r * ld + c;
    if constexpr (sizeof(T) == 4) {
      cp_async16(s, g, ok);
    } else {
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (ok) {
        const uint4 u = *reinterpret_cast<const uint4*>(g);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 a = __bfloat1622float2(h[0]);
        const float2 b = __bfloat1622float2(h[1]);
        const float2 c2 = __bfloat1622float2(h[2]);
        const float2 d = __bfloat1622float2(h[3]);
        lo = make_float4(a.x, a.y, b.x, b.y);
        hi = make_float4(c2.x, c2.y, d.x, d.y);
      }
      reinterpret_cast<float4*>(s)[0] = lo;
      reinterpret_cast<float4*>(s)[1] = hi;
    }
  }
}

// kKT values of cum and dt from key j0 on into cj[0..kKT), dj[0..kKT)
// (0 past Q), and cum[Q - 1] into dj[kKT], by cp.async
__device__ __forceinline__ void stage_keys(float* cj, float* dj,
                                           const float* cum, const float* dt,
                                           int j0, int Q) {
  const int t = threadIdx.x;
  if (t == 2 * kKT) cp_async4(dj + kKT, cum + Q - 1, true);
  if (t < 2 * kKT) {
    const int k = t % kKT, j = j0 + k;
    const bool ok = j < Q;
    const int jj = ok ? j : 0;
    if (t < kKT)
      cp_async4(cj + k, cum + jj, ok);
    else
      cp_async4(dj + k, dt + jj, ok);
  }
}

__host__ __device__ constexpr int keys_held(int Q) {
  return (Q + kKT - 1) / kKT * kKT < kChunk ? (Q + kKT - 1) / kKT * kKT
                                             : kChunk;
}

// floats of one head's staged key tile: x rows (stride P + 8), cum, dt,
// cum[Q - 1] (padded to 16 bytes)
template <int P>
__host__ __device__ constexpr int raw_tile() {
  return kKT * (P + 8) + 2 * kKT + 4;
}

// the ring of staged key tiles: cp.async keeps stages - 1 of them
// loading while one is multiplied (a load from L2 or HBM outlasts a
// tile's products); two at P = 128, where four would not fit
template <int P>
__host__ __device__ constexpr int stages() {
  return P <= 64 ? 4 : 2;
}

// floats of one head's split key tile: (hi, lo) pairs, stride P + 4
template <int P>
__host__ __device__ constexpr int split_tile() {
  return 2 * kKT * (P + 4);
}

// floats of dynamic shared memory for chunks of ``kc`` keys
template <int P, int N>
__host__ __device__ constexpr int smem_floats(int kc) {
  constexpr int NS = N < 64 ? N : 64;
  const int cb = kRows * (kChunk + 4);
  const int cb_stage = kRows * (N + 4) + stages<P>() * kKT * (N + 4);
  const int heads = 2 * stages<P>() * raw_tile<P>() + 2 * split_tile<P>();
  const int y_block = cb + (cb_stage > heads ? cb_stage : heads);
  const int st_block =
      kc * (NS + 8) + stages<P>() * raw_tile<P>() + split_tile<P>();
  return y_block > st_block ? y_block : st_block;
}

struct Geometry {
  int Q, rep, nsl, hs, npairs, nsb, state_blocks;
};

// One query stripe (rows i0 .. i0 + 63) of B/C row g for heads [h0, h1).
template <typename T, int P, int N>
__device__ void y_stripe(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ cum,
                         const T* __restrict__ Bg, const T* __restrict__ Cg,
                         float* __restrict__ y, long long g, int i0, int h0,
                         int h1, const Geometry& G, float* smem) {
  const int Q = G.Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rt = warp & 3;
  const int r0 = rt * 16 + gid, r1 = r0 + 8;  // rows within the stripe
  const int ia = i0 + r0, ib = i0 + r1;
  constexpr int ldc = N + 4, ldx = P + 8, ld2 = P + 4;
  // warp w: head w / 8 of each pair, rows 16 (w % 4) .. +16 and the CT
  // column tiles from 8 CT ((w / 4) % 2) on
  constexpr int CT = P / 8 / (kWarps / 8);
  const int kend = min(Q, i0 + kRows);
  constexpr int ldcb = kChunk + 4;
  float* CB = smem;                        // [kRows][ldcb]
  float* stage = smem + kRows * ldcb;
  float* Cs = stage;                       // [kRows][ldc]
  float* Bt = stage + kRows * ldc;         // [S][kKT][ldc]
  constexpr int S = stages<P>();
  uint2* xsplit = reinterpret_cast<uint2*>(stage + 2 * S * raw_tile<P>());

  for (int c0 = 0; c0 < kend; c0 += kChunk) {
    const int nkt = (min(kChunk, kend - c0) + kKT - 1) / kKT;
    // ---- C.B^T of the stripe against keys c0 .. c0 + 32 nkt --------------
    {
      // warp w: row tile w % 4 and CBT column tiles of 8 keys, from
      // key 8 CBT (w / 4) of each 32-key tile
      constexpr int CBT = kKT / 8 / (kWarps / 4);
      const int kw = (warp >> 2) * CBT * 8;
      stage_rows<T, kRows, N>(Cs, ldc, Cg, N, i0, Q, 0);
      auto stage_b = [&](int kt) {
        if (kt < nkt)
          stage_rows<T, kKT, N>(Bt + (kt % S) * kKT * ldc, ldc, Bg, N,
                                c0 + kt * kKT, Q, 0);
        cp_commit();
      };
      for (int kt = 0; kt < S - 1; ++kt) stage_b(kt);
      for (int kt = 0; kt < nkt; ++kt) {
        stage_b(kt + S - 1);
        cp_wait<S - 1>();
        __syncthreads();
        const float* Bb = Bt + (kt % S) * kKT * ldc;
        const int jt = c0 + kt * kKT + kw;  // this warp's first key
        if (jt <= i0 + rt * 16 + 15) {      // not all masked
          // two accumulators per column tile (even and odd k steps)
          // halve the chain of dependent products
          float acc[CBT][4] = {}, acc2[CBT][4] = {};
#pragma unroll 2
          for (int ks = 0; ks < N / 8; ks += 2) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = (ks + h) * 8 + tig;
              const float a[4] = {Cs[r0 * ldc + n], Cs[r1 * ldc + n],
                                  Cs[r0 * ldc + n + 4], Cs[r1 * ldc + n + 4]};
              const FragA fa = split_a(a);
#pragma unroll
              for (int c = 0; c < CBT; ++c) {
                const int key = kw + c * 8 + gid;
                const float b[2] = {Bb[key * ldc + n], Bb[key * ldc + n + 4]};
                mma3(h ? acc2[c] : acc[c], fa, b);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < CBT; ++c)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[c][k] += acc2[c][k];
#pragma unroll
          for (int c = 0; c < CBT; ++c) {
            const int col = kt * kKT + kw + c * 8 + 2 * tig;
            *reinterpret_cast<float2*>(CB + r0 * ldcb + col) =
                make_float2(acc[c][0], acc[c][1]);
            *reinterpret_cast<float2*>(CB + r1 * ldcb + col) =
                make_float2(acc[c][2], acc[c][3]);
          }
        }
        __syncthreads();
      }
    }

    // ---- the slice's heads, two at a time: (C.B^T o decay o dt) . x ------
    // Tile (q, kt): key tile kt of heads h0 + 2q and h0 + 2q + 1, in ring
    // slot (q nkt + kt) % S.  Loop counters, not divisions, track them.
    const int grp = warp >> 3, cw = ((warp >> 2) & 1) * CT;
    const int nq = (h1 - h0 + 1) / 2;
    auto stage_tile = [&](int q, int kt, int slot) {
      for (int hh = 0; q < nq && hh < 2 && h0 + 2 * q + hh < h1; ++hh) {
        const long long m = g * G.rep + h0 + 2 * q + hh;
        const int j0 = c0 + kt * kKT;
        float* xb = stage + (slot * 2 + hh) * raw_tile<P>();
        stage_rows<T, kKT, P>(xb, ldx, x + m * Q * P, P, j0, Q, 0);
        stage_keys(xb + kKT * ldx, xb + kKT * ldx + kKT, cum + m * Q,
                   dt + m * Q, j0, Q);
      }
      cp_commit();
    };
    int sq = 0, skt = 0, sslot = 0;  // the next tile to stage
    auto stage_next = [&]() {
      stage_tile(sq, skt, sslot);
      if (++skt == nkt) skt = 0, ++sq;
      if (++sslot == S) sslot = 0;
    };
    for (int f = 0; f < S - 1; ++f) stage_next();
    // this warp's fragment addresses: rows r0 / r1 of C.B^T, key tig
    const float* cba = CB + r0 * ldcb + tig;
    const float* cbb = CB + r1 * ldcb + tig;
    const uint2* xw = xsplit + (grp * kKT + tig) * ld2 + cw * 8 + gid;
    int slot = 0;
    for (int q = 0; q < nq; ++q) {
      const int heads = min(2, h1 - h0 - 2 * q);
      const long long m = g * G.rep + h0 + 2 * q + grp;
      float* ym = y + m * Q * P + (cw * 8 + 2 * tig);
      float acc[CT][4];
      float cia = 0.f, cib = 0.f;
      if (grp < heads) {
        cia = ia < Q ? cum[m * Q + ia] : 0.f;
        cib = ib < Q ? cum[m * Q + ib] : 0.f;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          float2 u = make_float2(0.f, 0.f), v = u;
          if (c0 > 0 && ia < Q)
            u = *reinterpret_cast<const float2*>(ym + ia * P + c * 8);
          if (c0 > 0 && ib < Q)
            v = *reinterpret_cast<const float2*>(ym + ib * P + c * 8);
          acc[c][0] = u.x;
          acc[c][1] = u.y;
          acc[c][2] = v.x;
          acc[c][3] = v.y;
        }
      }
      for (int kt = 0; kt < nkt; ++kt) {
        stage_next();
        cp_wait<S - 1>();
        __syncthreads();
        // x of the tile's heads split into TF32 (hi, lo) once for all
        // warps (unrolled: the loads of a thread's words go out at once)
        for (int hh = 0; hh < heads; ++hh) {
          const float* xb = stage + (slot * 2 + hh) * raw_tile<P>();
          uint2* xo = xsplit + hh * kKT * ld2;
          const float* xi = xb + (tid / P) * ldx + tid % P;
          uint2* xq = xo + (tid / P) * ld2 + tid % P;
#pragma unroll
          for (int k = 0; k < kKT * P / kThreads; ++k) {
            constexpr int dr = kThreads / P;  // rows a pass moves on
            uint32_t hi, lo;
            split(xi[k * dr * ldx], hi, lo);
            xq[k * dr * ld2] = make_uint2(hi, lo);
          }
        }
        __syncthreads();
        const int jt = c0 + kt * kKT;
        // some key of the tile is causal for this warp's rows
        if (grp < heads && jt <= i0 + rt * 16 + 15) {
          const float* cj =
              stage + (slot * 2 + grp) * raw_tile<P>() + kKT * ldx + tig;
          const float* dj = cj + kKT;
          const float* ca = cba + kt * kKT;
          const float* cb = cbb + kt * kKT;
#pragma unroll
          for (int ks = 0; ks < kKT / 8; ++ks) {
            const int ja = jt + ks * 8 + tig, jb = ja + 4;
            const int o = ks * 8;
            // masked before the exp, as the reference does: the exponent
            // is -inf above the diagonal (exp gives 0, never inf), and
            // C.B^T there, not formed, is read as 0; selects, no branches
            const float a[4] = {
                (ja <= ia ? ca[o] : 0.f) *
                    __expf(ja <= ia ? cia - cj[o] : -INFINITY) * dj[o],
                (ja <= ib ? cb[o] : 0.f) *
                    __expf(ja <= ib ? cib - cj[o] : -INFINITY) * dj[o],
                (jb <= ia ? ca[o + 4] : 0.f) *
                    __expf(jb <= ia ? cia - cj[o + 4] : -INFINITY) * dj[o + 4],
                (jb <= ib ? cb[o + 4] : 0.f) *
                    __expf(jb <= ib ? cib - cj[o + 4] : -INFINITY) *
                    dj[o + 4]};
            const FragA fa = split_a(a);
            uint32_t bh[CT][2], bl[CT][2];
#pragma unroll
            for (int c = 0; c < CT; ++c) {
              const uint2 u = xw[o * ld2 + c * 8];
              const uint2 v = xw[(o + 4) * ld2 + c * 8];
              bh[c][0] = u.x;
              bh[c][1] = v.x;
              bl[c][0] = u.y;
              bl[c][1] = v.y;
            }
            // product-major: the three products into one accumulator are
            // CT mma apart, so their latencies overlap
#pragma unroll
            for (int c = 0; c < CT; ++c) mma(acc[c], fa.l, bh[c]);
#pragma unroll
            for (int c = 0; c < CT; ++c) mma(acc[c], fa.h, bl[c]);
#pragma unroll
            for (int c = 0; c < CT; ++c) mma(acc[c], fa.h, bh[c]);
          }
        }
        // the tile's cum and dt are read above: the next stage may refill
        // this slot only after every warp is past here
        __syncthreads();
        if (++slot == S) slot = 0;
      }
      if (grp < heads) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          if (ia < Q)
            *reinterpret_cast<float2*>(ym + ia * P + c * 8) =
                make_float2(acc[c][0], acc[c][1]);
          if (ib < Q)
            *reinterpret_cast<float2*>(ym + ib * P + c * 8) =
                make_float2(acc[c][2], acc[c][3]);
        }
      }
    }
  }
}

// State columns n0 .. n0 + NS of B/C row g for heads [h0, h1).  The 16
// warps tile the (P, NS) output WR x WC: warp w owns row tile w / WC and
// the column tiles w % WC, w % WC + WC, ...; x o w of each key tile is
// split into TF32 (hi, lo) once for all warps.
template <typename T, int P, int N>
__device__ void state_cols(const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ cum,
                           const T* __restrict__ Bg, float* __restrict__ st,
                           long long g, int n0, int h0, int h1,
                           const Geometry& G, float* smem) {
  constexpr int NS = N < 64 ? N : 64;
  constexpr int CTs = NS / 8;            // column tiles: 2, 4 or 8
  constexpr int RTs = P / 16;            // row tiles: 1, 2, 4 or 8
  constexpr int WC = kWarps / RTs;       // warps along the columns
  constexpr int CTW = (CTs + WC - 1) / WC;
  constexpr int ldb = NS + 8, ldx = P + 8, ld2 = P + 4;
  const int Q = G.Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rt = warp / WC, cw = warp % WC;
  const int p = rt * 16 + gid;
  float* Bs = smem;                                  // [keys][ldb]
  float* stage = smem + keys_held(Q) * ldb;          // raw x tiles
  constexpr int S = stages<P>();
  uint2* xsplit = reinterpret_cast<uint2*>(stage + S * raw_tile<P>());

  for (int c0 = 0; c0 < Q; c0 += kChunk) {
    const int nkt = (min(kChunk, Q - c0) + kKT - 1) / kKT;
    for (int kt = 0; kt < nkt; ++kt)
      stage_rows<T, kKT, NS>(Bs + kt * kKT * ldb, ldb, Bg, N, c0 + kt * kKT, Q,
                             n0);
    cp_commit();
    // tile (h, kt): key tile kt of head h0 + h, in ring slot
    // (h nkt + kt) % S; loop counters, not divisions, track them
    const int nh = h1 - h0;
    auto stage_tile = [&](int h, int kt, int slot) {
      if (h < nh) {
        const long long m = g * G.rep + h0 + h;
        const int j0 = c0 + kt * kKT;
        float* xb = stage + slot * raw_tile<P>();
        stage_rows<T, kKT, P>(xb, ldx, x + m * Q * P, P, j0, Q, 0);
        stage_keys(xb + kKT * ldx, xb + kKT * ldx + kKT, cum + m * Q,
                   dt + m * Q, j0, Q);
      }
      cp_commit();
    };
    int sh = 0, skt = 0, sslot = 0;  // the next tile to stage
    auto stage_next = [&]() {
      stage_tile(sh, skt, sslot);
      if (++skt == nkt) skt = 0, ++sh;
      if (++sslot == S) sslot = 0;
    };
    for (int f = 0; f < S - 1; ++f) stage_next();
    // this warp's fragment addresses: x o w rows tig / P column p, and B
    // rows tig / this warp's column tiles
    const uint2* xw = xsplit + tig * ld2 + p;
    const float* bw = Bs + tig * ldb + cw * 8 + gid;
    int slot = 0;
    for (int h = 0; h < nh; ++h) {
      const long long m = g * G.rep + h0 + h;
      float* sm = st + m * P * N + p * N + n0 + cw * 8 + 2 * tig;
      float acc[CTW][4];
#pragma unroll
      for (int k = 0; k < CTW; ++k) {
        float2 u = make_float2(0.f, 0.f), v = u;
        if (c0 > 0 && cw + k * WC < CTs) {
          u = *reinterpret_cast<const float2*>(sm + k * WC * 8);
          v = *reinterpret_cast<const float2*>(sm + 8 * N + k * WC * 8);
        }
        acc[k][0] = u.x;
        acc[k][1] = u.y;
        acc[k][2] = v.x;
        acc[k][3] = v.y;
      }
      for (int kt = 0; kt < nkt; ++kt) {
        stage_next();
        cp_wait<S - 1>();
        __syncthreads();
        {  // x o w of the tile split into TF32 (hi, lo) once for all warps
          const float* xb = stage + slot * raw_tile<P>();
          const float* cj = xb + kKT * ldx;
          const float* dj = cj + kKT;
          const float last = dj[kKT];
          const int r0 = tid / P, c = tid % P;
#pragma unroll
          for (int k = 0; k < kKT * P / kThreads; ++k) {
            const int r = r0 + k * (kThreads / P);
            const int j = c0 + kt * kKT + r;
            const float w = j < Q ? __expf(last - cj[r]) * dj[r] : 0.f;
            uint32_t hi, lo;
            split(xb[r * ldx + c] * w, hi, lo);
            xsplit[r * ld2 + c] = make_uint2(hi, lo);
          }
        }
        __syncthreads();
        if (cw < CTs) {
          const float* bt = bw + kt * kKT * ldb;
#pragma unroll
          for (int ks = 0; ks < kKT / 8; ++ks) {
            const int o = ks * 8;
            const uint2 u0 = xw[o * ld2], u1 = xw[o * ld2 + 8];
            const uint2 u2 = xw[(o + 4) * ld2], u3 = xw[(o + 4) * ld2 + 8];
            const uint32_t ah[4] = {u0.x, u1.x, u2.x, u3.x};
            const uint32_t al[4] = {u0.y, u1.y, u2.y, u3.y};
            uint32_t bh[CTW][2], bl[CTW][2];
#pragma unroll
            for (int k = 0; k < CTW; ++k) {
              // a column tile past NS (warps beyond it) reads tile 0
              const int cofs = cw + k * WC < CTs ? k * WC * 8 : -cw * 8;
              split(bt[o * ldb + cofs], bh[k][0], bl[k][0]);
              split(bt[(o + 4) * ldb + cofs], bh[k][1], bl[k][1]);
            }
            // product-major, as in y_stripe
#pragma unroll
            for (int k = 0; k < CTW; ++k)
              if (cw + k * WC < CTs) mma(acc[k], al, bh[k]);
#pragma unroll
            for (int k = 0; k < CTW; ++k)
              if (cw + k * WC < CTs) mma(acc[k], ah, bl[k]);
#pragma unroll
            for (int k = 0; k < CTW; ++k)
              if (cw + k * WC < CTs) mma(acc[k], ah, bh[k]);
          }
        }
        if (++slot == S) slot = 0;
      }
#pragma unroll
      for (int k = 0; k < CTW; ++k) {
        if (cw + k * WC >= CTs) continue;
        *reinterpret_cast<float2*>(sm + k * WC * 8) =
            make_float2(acc[k][0], acc[k][1]);
        *reinterpret_cast<float2*>(sm + 8 * N + k * WC * 8) =
            make_float2(acc[k][2], acc[k][3]);
      }
    }
    __syncthreads();  // before the next chunk restages B
  }
}

// Blocks [0, state_blocks) are state blocks (g, head slice, column
// block); the rest are y blocks (g, head slice, stripe pair).
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ st, Geometry G) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NS = N < 64 ? N : 64;
  const long long q = G.Q;
  long long b = blockIdx.x;
  if (b < G.state_blocks) {
    const long long per_g = static_cast<long long>(G.nsl) * G.nsb;
    const long long g = b / per_g;
    const int sl = static_cast<int>((b % per_g) / G.nsb);
    const int nb = static_cast<int>(b % G.nsb);
    const int h0 = sl * G.hs, h1 = min(G.rep, h0 + G.hs);
    state_cols<T, P, N>(x, dt, cum, Bm + g * q * N, st, g, nb * NS, h0, h1,
                        G, smem);
    return;
  }
  b -= G.state_blocks;
  const long long per_g = static_cast<long long>(G.nsl) * G.npairs;
  const long long g = b / per_g;
  const int sl = static_cast<int>((b % per_g) / G.npairs);
  const int pr = static_cast<int>(b % G.npairs);
  const int h0 = sl * G.hs, h1 = min(G.rep, h0 + G.hs);
  const int nt = (G.Q + kRows - 1) / kRows;
  const int heavy = nt - 1 - pr;
  y_stripe<T, P, N>(x, dt, cum, Bm + g * q * N, Cm + g * q * N, y, g,
                    heavy * kRows, h0, h1, G, smem);
  if (heavy != pr)
    y_stripe<T, P, N>(x, dt, cum, Bm + g * q * N, Cm + g * q * N, y, g,
                      pr * kRows, h0, h1, G, smem);
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* cum, const void* B,
           const void* C, void* y, void* st, long long M, long long Q,
           long long rep, cudaStream_t stream) {
  constexpr int NS = N < 64 ? N : 64;
  static int per_sm = 0;  // resident blocks an SM takes at the most smem
  if (!per_sm) {
    const int most =
        smem_floats<P, N>(kChunk) * static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(ssd_chunk_kernel<T, P, N>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssd_chunk_kernel<T, P, N>, kThreads, most);
    if (per_sm < 1) per_sm = 1;
  }
  const long long Mg = M / rep;
  const long long nt = (Q + kRows - 1) / kRows;
  Geometry G;
  G.Q = static_cast<int>(Q);
  G.rep = static_cast<int>(rep);
  G.npairs = static_cast<int>((nt + 1) / 2);
  G.nsb = N / NS;
  // head slices: C.B^T and the B chunk are formed once per slice, a block
  // walks its slice's heads, and the grid runs in waves of `slots`
  // blocks; take the slicing with the fewest waves x heads a block, then
  // at least two waves (room to even out uneven blocks), then the fewest
  // slices
  const long long units = Mg * (G.npairs + G.nsb);
  const long long slots = static_cast<long long>(per_sm) * sm_count();
  long long best_cost = -1, best_hs = rep;
  bool best_two = false;
  for (long long hs = rep; hs >= 1; --hs) {
    const long long nsl = (rep + hs - 1) / hs;
    if ((rep + nsl - 1) / nsl != hs) continue;  // the same as fewer slices
    const long long waves = (units * nsl + slots - 1) / slots;
    const long long cost = waves * hs;
    const bool two = waves >= 2;
    if (best_cost < 0 || cost < best_cost ||
        (cost == best_cost && two && !best_two)) {
      best_cost = cost;
      best_hs = hs;
      best_two = two;
    }
  }
  G.hs = static_cast<int>(best_hs);
  G.nsl = static_cast<int>((rep + best_hs - 1) / best_hs);
  G.state_blocks = static_cast<int>(Mg * G.nsl * G.nsb);
  const long long blocks = Mg * G.nsl * (G.nsb + G.npairs);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes =
      smem_floats<P, N>(keys_held(G.Q)) * static_cast<int>(sizeof(float));
  ssd_chunk_kernel<T, P, N><<<static_cast<unsigned>(blocks), kThreads, bytes,
                              stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(st), G);
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
// x (M, Q, P), dt and cum (M, Q), B and C (M / rep, Q, N), all contiguous
// and 16-byte aligned; y (M, Q, P) and state (M, P, N) float32.
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
