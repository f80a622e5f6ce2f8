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
// What bounds it on this card: at the model's prefill shapes it does
// 4 * D flops per unmasked (query, key) pair and reads each operand once,
// so it is bound by arithmetic (internlm2-1.8b prefill, S = 512, D = 128:
// ~64 flops a byte against the card's ~20 in f32 on CUDA cores).  This
// first kernel runs in f32 on CUDA cores (67 TFLOP/s peak), not on the
// tensor cores: wgmma, TMA and bf16 operands are left to a redesign.
//
// Design.  The TPU kernel walks the KV blocks as the innermost grid axis
// and carries m, l and acc in VMEM scratch from one grid step to the
// next; a Hopper block cannot carry state across grid steps, so here one
// block of 256 threads owns a tile of 64 query rows of one (b, h) and
// loops over the KV tiles (32 rows each) itself:
//   * the Q tile is staged once in shared memory (f32, rows padded by one
//     word against bank conflicts), each K and V tile per step;
//   * each thread owns 4 query rows x 2 key columns of the score tile and
//     4 rows x D/16 columns of the output accumulator, all in registers;
//     m and l per row live in registers too, replicated over the 16
//     threads that share a row, and row max and row sum are xor shuffles
//     over those 16 lanes;
//   * the probabilities go through shared memory to the P.V product;
//   * the order of operations is the reference's: s = q.k * scale, then
//     softcap * tanh(s / softcap), then the mask to -1e30, then the online
//     softmax; the final divide is by max(l, 1e-30);
//   * a KV tile is skipped when the TPU kernel's condition says it is
//     fully masked (:36-41), so a window does only the work it implies;
//   * any S >= 1: rows and keys past S are masked and zero filled;
//   * operands are read through (b, h, s) strides with a unit d stride,
//     so the model's (B, S, H, D) activations need no transpose; the
//     output is written through strides as well.
// Shared memory at D = 128 is 74,368 bytes, over the 48 KiB default, so
// each launch opts in with cudaFuncSetAttribute.
//
// The C entry returns cudaGetLastError() so the Python wrapper can raise
// when a launch is refused.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 32;         // key rows per KV tile
constexpr int kThreads = 256;   // 16 x 16: tx picks columns, ty rows
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;  // element strides; the d stride is 1
};

constexpr int smem_bytes(int D) {
  return (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides sq,
             Strides sk, Strides sv, Strides so, int Hq, int group, int S,
             float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);     // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);     // [kBK][D]
  float* Ps = Vs + kBK * D;           // [kBQ][kBK + 1]

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / group;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, s = q0 + r;
    Qs[r * (D + 1) + d] = s < S ? to_f(qb[s * sq.s + d]) : 0.f;
  }

  constexpr int DJ = D / 16;
  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (S + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    // the TPU kernel's skip: the tile is fully masked for every row
    bool live = true;
    if (causal) live = k0 <= q0 + kBQ - 1;
    if (window > 0) live = live && (k0 + kBK - 1 >= q0 - window + 1);
    if (!live) continue;

    __syncthreads();  // the last tile's Ks, Vs and Ps reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D, s = k0 + r;
      const bool in = s < S;
      Ks[r * (D + 1) + d] = in ? to_f(kb[s * sk.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[s * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        bool keep = kp < S;
        if (causal) keep = keep && qp >= kp;
        if (window > 0) keep = keep && qp - kp < window;
        s = keep ? s : kNegInf;
        sc[i][j] = s;
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(kFull, rsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(&ob[s * so.s + tx + 16 * j], acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           long long B, long long Hq, long long Hkv, long long S,
           Strides sq, Strides sk, Strides sv, Strides so, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(D);
  cudaFuncSetAttribute(flash_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so,
      static_cast<int>(Hq), static_cast<int>(Hq / Hkv),
      static_cast<int>(S), scale, causal, window, softcap);
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
// operand (b, h, s); the d stride must be 1.  window <= 0 and
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
