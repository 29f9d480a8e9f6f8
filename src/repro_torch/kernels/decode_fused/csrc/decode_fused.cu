// The decode step's elementwise glue for Hopper (sm_90a), fused: three
// kernels between the GEMMs and the paged attention kernel of a dense layer.
//
// Replaces: no TPU kernel.  The JAX package leaves this glue to XLA, which
//   fuses it inside its jitted decode step; the port's decode step ran it as
//   PyTorch's elementwise, reduction and index kernels (about 69 of them a
//   layer: models/layers.py rms_norm, rope, the K/V page writes of
//   attn_decode, the activation and each residual add), every one a node of
//   the captured decode graph.
//
// Computes (ref.py holds the plain chains, which each kernel rounds as):
//   * add_rms_norm_kernel: for each row of x [rows, d] (and y, optional),
//     s = x + alpha * y formed in fp32 and rounded once to the activations'
//     type (alpha, the residual multiplier, is 1 but for muP configs; a
//     product by 1 is exact, so alpha 1 gives x + y's bits), then
//     out = s * rsqrt(mean(s^2) + eps) * (1 + w) in fp32, rounded.
//   * rope_kv_write_kernel: for one token per sequence, q [B, H, hd] and
//     k, v [B, KV, hd] (the projections' outputs): q_norm / k_norm where
//     given (rms_norm over hd, rounded), then the half-split rotary
//     embedding at position pos (angles float(pos) * freq[i] in fp32,
//     full-precision sincosf), rounded, or no rotation at all where the
//     frequency table is null (NoPE); writes the rotated q to q_out and
//     the rotated k and v into their cache slot.  Paged layers (ring = 0):
//     pos = context_lens[b] - 1, slot row pos.  Window rings (ring = S):
//     pos = max(context_lens[b] - 1, 0), slot row pos % S.  The row lies in
//     page tables[b][row / page] at offset row % page.
//   * act_mul_kernel: act(g) * u with act silu or tanh-gelu, rounded after
//     the activation and after the product.
//   Rounding and the order of each fp32 product and sum follow the chains'
//   separate PyTorch kernels (__fmul_rn and friends, so that nvcc does not
//   contract them into FMAs); the sums of squares are taken in another
//   order than PyTorch's reductions.
//
// Bound: device memory, and at the decode step's shapes launch latency.  An
//   add-norm over minicpm-2b's [16, 2304] bf16 moves 0.3 MB (0.1 us at
//   3.35 TB/s); the rotary write of its 36 + 36 heads at hd 64 about 0.2
//   MB.  What costs is the number of launches and the gaps between them, so
//   each kernel is one launch and takes its indices and angles from the
//   device: no host read, and the step stays capturable in a CUDA graph.
//
// Design:
//   * add_rms_norm: one block of 256 threads a row; 16-byte vectors where
//     the row and pointers allow it.  Pass 1 forms and stores the rounded
//     sum and its sum of squares; one block reduction; pass 2 re-reads the
//     sum each thread stored and writes the norm.
//   * rope_kv_write: one warp a head, q heads then k heads of every
//     sequence; lane i holds the pairs (i + 32 t, i + 32 t + hd / 2), so hd
//     up to 256 fits in registers and the qk norm is a warp reduction.  A k
//     head's warp also copies its v head.  The frequencies come from a
//     [hd / 2] fp32 table built once (ops.rope_table) with rope's own
//     expression.
//   * act_mul: one thread a 16-byte vector of g and u.

#include "vec.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNormThreads = 256;
constexpr int kActThreads = 256;
constexpr int kRopeWarps = 4;
constexpr int kMaxPairs = 4;   // pairs a lane holds: hd <= 256

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// x rounded to T and read back as float: what storing it in T does.
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, bf16) {
  return __bfloat162float(__float2bfloat16(x));
}

// V consecutive elements as floats: V = 1, or one 16-byte vector.
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* a) {
  if constexpr (V == 1) {
    a[0] = to_float(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte vector");
    repro::load16(p, a);
  }
}

__device__ __forceinline__ void pack16(const float* a, uint4* raw, float) {
  float* f = reinterpret_cast<float*>(raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = a[i];
}

__device__ __forceinline__ void pack16(const float* a, uint4* raw, bf16) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* a) {
  if constexpr (V == 1) {
    repro::store(p, a[0]);
  } else {
    uint4 raw;
    pack16(a, &raw, T());
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over the block, in every thread.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kNormThreads / 32];
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  return warp_sum(lane < kNormThreads / 32 ? part[lane] : 0.f);
}

// s * r * (1 + w): rms_norm's two fp32 products.
__device__ __forceinline__ float scale(float s, float r, float w) {
  return __fmul_rn(__fmul_rn(s, r), __fadd_rn(1.f, w));
}

template <typename T, int V>
__global__ void __launch_bounds__(kNormThreads)
add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ w, T* sum, T* __restrict__ out,
                    int d, float eps, float alpha) {
  const size_t base = (size_t)blockIdx.x * d;
  x += base;
  out += base;
  if (y != nullptr) {
    y += base;
    sum += base;
  }
  float ss = 0.f;
  for (int i = threadIdx.x * V; i < d; i += kNormThreads * V) {
    float a[V];
    load_vec<V>(x + i, a);
    if (y != nullptr) {
      float b[V];
      load_vec<V>(y + i, b);
#pragma unroll
      for (int k = 0; k < V; ++k)
        a[k] = round_as(__fadd_rn(a[k], __fmul_rn(alpha, b[k])), T());
      store_vec<V>(sum + i, a);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) ss = __fadd_rn(ss, __fmul_rn(a[k], a[k]));
  }
  const float r =
      rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss), 1.f / (float)d), eps));
  // each thread re-reads the elements it stored in pass 1
  const T* s = y != nullptr ? sum : x;
  for (int i = threadIdx.x * V; i < d; i += kNormThreads * V) {
    float a[V], g[V];
    load_vec<V>(s + i, a);
    load_vec<V>(w + i, g);
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = scale(a[k], r, g[k]);
    store_vec<V>(out + i, a);
  }
}

struct RopeArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* q_norm;   // [hd] or null
  const void* k_norm;   // [hd] or null
  const float* freq;    // [hd / 2], or null: no rotation
  const int* context_lens;
  const int* tables;
  void* q_out;
  void* k_pages;
  void* v_pages;
  int B, H, KV, hd, page, table_stride, ring;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(kRopeWarps * 32)
rope_kv_write_kernel(RopeArgs a) {
  const int lane = threadIdx.x % 32;
  const int heads = a.H + a.KV;
  const int gw = blockIdx.x * kRopeWarps + threadIdx.x / 32;
  if (gw >= a.B * heads) return;
  const int b = gw / heads, h = gw % heads;
  const bool is_q = h < a.H;
  const int kvh = h - a.H;
  const int half = a.hd / 2;
  int pos = a.context_lens[b] - 1;
  if (a.ring > 0) pos = max(pos, 0);
  const T* src = is_q
      ? static_cast<const T*>(a.q) + ((size_t)b * a.H + h) * a.hd
      : static_cast<const T*>(a.k) + ((size_t)b * a.KV + kvh) * a.hd;
  float x1[kMaxPairs], x2[kMaxPairs];
  float ss = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxPairs; ++t) {
    const int j = lane + 32 * t;
    x1[t] = x2[t] = 0.f;
    if (j < half) {
      x1[t] = to_float(src[j]);
      x2[t] = to_float(src[j + half]);
      ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(x1[t], x1[t]),
                                   __fmul_rn(x2[t], x2[t])));
    }
  }
  const T* nw = static_cast<const T*>(is_q ? a.q_norm : a.k_norm);
  if (nw != nullptr) {   // the same for the whole warp
    const float r =
        rsqrtf(__fadd_rn(__fmul_rn(warp_sum(ss), 1.f / (float)a.hd), a.eps));
#pragma unroll
    for (int t = 0; t < kMaxPairs; ++t) {
      const int j = lane + 32 * t;
      if (j < half) {
        x1[t] = round_as(scale(x1[t], r, to_float(nw[j])), T());
        x2[t] = round_as(scale(x2[t], r, to_float(nw[j + half])), T());
      }
    }
  }
  T* dst;
  if (is_q) {
    dst = static_cast<T*>(a.q_out) + ((size_t)b * a.H + h) * a.hd;
  } else {
    const int row = a.ring > 0 ? pos % a.ring : pos;
    if (row < 0) return;   // a paged row of length 0 has no slot
    const int pg = a.tables[(size_t)b * a.table_stride + row / a.page];
    const size_t off = (((size_t)pg * a.page + row % a.page) * a.KV + kvh)
                       * a.hd;
    dst = static_cast<T*>(a.k_pages) + off;
    const T* vs = static_cast<const T*>(a.v) + ((size_t)b * a.KV + kvh) * a.hd;
    T* vd = static_cast<T*>(a.v_pages) + off;
    for (int j = lane; j < a.hd; j += 32) vd[j] = vs[j];
  }
  if (a.freq == nullptr) {   // NoPE: the (normed) head as it is
#pragma unroll
    for (int t = 0; t < kMaxPairs; ++t) {
      const int j = lane + 32 * t;
      if (j < half) {
        repro::store(dst + j, x1[t]);
        repro::store(dst + j + half, x2[t]);
      }
    }
    return;
  }
  const float p = (float)pos;
#pragma unroll
  for (int t = 0; t < kMaxPairs; ++t) {
    const int j = lane + 32 * t;
    if (j < half) {
      float sn, cs;
      sincosf(__fmul_rn(p, a.freq[j]), &sn, &cs);
      repro::store(dst + j, __fsub_rn(__fmul_rn(x1[t], cs),
                                      __fmul_rn(x2[t], sn)));
      repro::store(dst + j + half, __fadd_rn(__fmul_rn(x1[t], sn),
                                             __fmul_rn(x2[t], cs)));
    }
  }
}

// PyTorch's silu: x / (1 + exp(-x)).
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// PyTorch's tanh-approximated gelu, written as its CUDA kernel writes it.
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 1.41421356237309504880 * 1.12837916709551257390 * 0.5;
  constexpr float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

template <typename T, int V>
__global__ void __launch_bounds__(kActThreads)
act_mul_kernel(const T* __restrict__ g, const T* __restrict__ u,
               T* __restrict__ out, long long n, int gelu) {
  const long long i =
      ((long long)blockIdx.x * kActThreads + threadIdx.x) * V;
  if (i >= n) return;
  float a[V], b[V];
  load_vec<V>(g + i, a);
  load_vec<V>(u + i, b);
#pragma unroll
  for (int k = 0; k < V; ++k)
    a[k] = __fmul_rn(round_as(gelu ? gelu_tanh(a[k]) : silu(a[k]), T()), b[k]);
  store_vec<V>(out + i, a);
}

template <typename T, int V>
int launch_add_rms_norm(const void* x, const void* y, const void* w, void* sum,
                        void* out, int rows, int d, float eps, float alpha,
                        cudaStream_t stream) {
  add_rms_norm_kernel<T, V><<<rows, kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(w), static_cast<T*>(sum), static_cast<T*>(out), d,
      eps, alpha);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_act_mul(const void* g, const void* u, void* out, long long n,
                   int gelu, cudaStream_t stream) {
  const long long per = (long long)kActThreads * V;
  act_mul_kernel<T, V><<<(unsigned)((n + per - 1) / per), kActThreads, 0,
                         stream>>>(static_cast<const T*>(g),
                                   static_cast<const T*>(u),
                                   static_cast<T*>(out), n, gelu);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: 1 where d and the pointers allow 16-byte vectors, else 0.  alpha:
// the residual multiplier of y.
extern "C" int add_rms_norm_launch(const void* x, const void* y, const void* w,
                                   void* sum, void* out, int rows, int d,
                                   float eps, float alpha, int vec,
                                   int is_bf16, void* stream) {
  if (rows < 1 || d < 1 || (vec && d % (is_bf16 ? 8 : 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? launch_add_rms_norm<bf16, 8>(x, y, w, sum, out, rows, d, eps,
                                              alpha, s)
               : launch_add_rms_norm<bf16, 1>(x, y, w, sum, out, rows, d, eps,
                                              alpha, s);
  return vec ? launch_add_rms_norm<float, 4>(x, y, w, sum, out, rows, d, eps,
                                             alpha, s)
             : launch_add_rms_norm<float, 1>(x, y, w, sum, out, rows, d, eps,
                                             alpha, s);
}

extern "C" int rope_kv_write_launch(const void* q, const void* k,
                                    const void* v, const void* q_norm,
                                    const void* k_norm, const void* freq,
                                    const void* context_lens,
                                    const void* tables, void* q_out,
                                    void* k_pages, void* v_pages, int B, int H,
                                    int KV, int hd, int page, int table_stride,
                                    int ring, float eps, int is_bf16,
                                    void* stream) {
  if (B < 1 || H < 1 || KV < 1 || hd < 2 || hd % 2 || hd > 64 * kMaxPairs ||
      page < 1 || ring < 0)
    return (int)cudaErrorInvalidValue;
  RopeArgs a{q, k, v, q_norm, k_norm, static_cast<const float*>(freq),
             static_cast<const int*>(context_lens),
             static_cast<const int*>(tables), q_out, k_pages, v_pages,
             B, H, KV, hd, page, table_stride, ring, eps};
  const int warps = B * (H + KV);
  const dim3 grid((warps + kRopeWarps - 1) / kRopeWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    rope_kv_write_kernel<bf16><<<grid, kRopeWarps * 32, 0, s>>>(a);
  else
    rope_kv_write_kernel<float><<<grid, kRopeWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// act: 0 silu, 1 tanh-gelu.  vec: 1 where n and the pointers allow 16-byte
// vectors, else 0.
extern "C" int act_mul_launch(const void* g, const void* u, void* out,
                              long long n, int act, int vec, int is_bf16,
                              void* stream) {
  if (n < 1 || (act != 0 && act != 1) || (vec && n % (is_bf16 ? 8 : 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? launch_act_mul<bf16, 8>(g, u, out, n, act, s)
               : launch_act_mul<bf16, 1>(g, u, out, n, act, s);
  return vec ? launch_act_mul<float, 4>(g, u, out, n, act, s)
             : launch_act_mul<float, 1>(g, u, out, n, act, s);
}
