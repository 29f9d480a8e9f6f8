// Causal / sliding-window GQA flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   _flash_kernel / flash_attention_pallas (Pallas TPU kernel).
//
// Computes: q [B, Lq, H, hd], k/v [B, Lk, KV, hd] -> o [B, Lq, H, hd].  The
//   q rows are the tail of k (q_offset = Lk - Lq), so row i sits at absolute
//   position i + Lk - Lq: that one rule carries both one-shot prefill
//   (Lq = Lk) and a prefill chunk attending over its staged prefix
//   (Lk = pos0 + C).  Optional causal mask, sliding window (ki > qi - window)
//   and tanh softcap after the 1/sqrt(hd) scale.  Query head h reads KV head
//   h / G.  Online softmax in fp32; fully masked key tiles are never visited.
//   Unlike the Pallas kernel, Lq and Lk may be any length: the ragged edges
//   of both are masked here.
//
// Bound: operations.  Causal prefill at L = 2048 does about 34 GFLOP per
//   layer against 67 MB of q/k/v/o in bf16: ~500 flops per byte, above the
//   ~295 at which Hopper's bf16 tensor cores, not memory, are the limit.
//
// Design: one block of 256 threads per (64-row q tile, head, sequence).  The
//   q tile stays in shared memory; 64-key tiles of K and then V pass through
//   one shared buffer (rows padded by one float against bank conflicts).
//   Each thread owns a 4 x 4 patch of the score tile and 4 rows x hd/16
//   columns of the output accumulator in registers; row max and row sum are
//   reduced with shuffles across the 16 threads that share a row.  The key
//   range of a q tile is cut to what the causal and window masks leave.
//   The products run on the fp32 CUDA cores: mma/wgmma tensor-core tiles
//   and TMA loads are later work, and that gap is what keeps this kernel
//   far from its bound.

#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns

// NJ: hd / 16 rounded up to the instantiation (4 for hd <= 64, 8 for <= 128)
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk,
             int H, int KV, int hd, long long sqb, long long skb,
             long long svb, long long sob, int causal, int window,
             float softcap, float scale) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Lk - Lq;
  const int ld = hd + 1;
  const int nj = hd / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  constexpr int vec = 16 / (int)sizeof(T);
  const int chunks = hd / vec;

  extern __shared__ float smem[];
  float* qs = smem;            // [kBQ][ld]
  float* kv = qs + kBQ * ld;   // [kBK][ld]: the K tile, then the V tile
  float* ps = kv + kBK * ld;   // [kBQ][kBK + 1]: probabilities

  const T* qb = q + b * sqb + (size_t)h * hd;
  const T* kb = k + b * skb + (size_t)kvh * hd;
  const T* vb = v + b * svb + (size_t)kvh * hd;
  const size_t q_row = (size_t)H * hd, kv_row = (size_t)KV * hd;

  // rows past the end of the array load as zeros
  auto load_tile = [&](const T* base, size_t row_stride, int first, int limit,
                       float* dst) {
    for (int i = tid; i < kBQ * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      float tmp[8];
      if (first + r < limit) {
        repro::load16(base + (size_t)(first + r) * row_stride + c * vec, tmp);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) tmp[e] = 0.f;
      }
      for (int e = 0; e < vec; ++e) dst[r * ld + c * vec + e] = tmp[e];
    }
  };

  load_tile(qb, q_row, q0, Lq, qs);

  // keys this q tile can see under the causal and window masks
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + kBQ, Lq) - 1 + off;
  const int k_hi = causal ? min(Lk, q_hi + 1) : Lk;
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();  // q tile loaded / previous V tile consumed
    load_tile(kb, kv_row, kt, Lk, kv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = kv[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const int qi = r + off;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = kt + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = r < Lq && ki < k_hi;
        if (causal) ok = ok && ki <= qi;
        if (window > 0) ok = ok && ki > qi - window;
        s[i][j] = ok ? x : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o2));
      const float m_new = fmaxf(m[i], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float a = __expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - m_use);
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o2);
      l[i] = l[i] * a + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
    __syncthreads();  // K tile consumed, P written
    load_tile(vb, kv_row, kt, Lk, kv);
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float vv = kv[c * ld + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + b * sob + (size_t)r * q_row + (size_t)h * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) repro::store(orow + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Lq, int Lk, int H, int KV, int hd, long long sqb,
           long long skb, long long svb, long long sob, int causal,
           int window, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)kBQ * (hd + 1) + (size_t)kBQ * (kBK + 1));
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, H, KV, hd, sqb,
      skb, svb, sob, causal, window, softcap, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Lq, int Lk, int H, int KV, int hd, long long sqb,
              long long skb, long long svb, long long sob, int causal,
              int window, float softcap, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 4>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb, skb, svb, sob,
                        causal, window, softcap, stream);
  return launch<T, 8>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb, skb, svb, sob,
                      causal, window, softcap, stream);
}

}  // namespace

// Batch strides are in elements; inside a sequence q/k/v/o are contiguous
// [L, heads, hd].  window <= 0 means no window, softcap <= 0 no softcap.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Lq,
                                      int Lk, int H, int KV, int hd,
                                      long long sqb, long long skb,
                                      long long svb, long long sob,
                                      int causal, int window, float softcap,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb,
                                    skb, svb, sob, causal, window, softcap, s);
  return launch_hd<float>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb, skb, svb,
                          sob, causal, window, softcap, s);
}
