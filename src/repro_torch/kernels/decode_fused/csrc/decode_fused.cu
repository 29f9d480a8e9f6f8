// The dense layer's elementwise glue for Hopper (sm_90a), fused: kernels
// between the GEMMs and the attention kernels of a dense layer, in the
// decode step and in prefill.
//
// Replaces: no TPU kernel.  The JAX package leaves this glue to XLA, which
//   fuses it inside its jitted decode step and prefill; the port ran it as
//   PyTorch's elementwise, reduction and index kernels (about 69 of them a
//   decode layer: models/layers.py rms_norm, rope, the K/V page writes of
//   attn_decode, the activation and each residual add, every one a node of
//   the captured decode graph; about 70 an eager prefill layer, each its
//   own launch from the host).
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
//   * rope_kv_prefill_kernel: the same qk_norm and rotation for the rows of
//     a prompt or chunk, q [B, L, H, hd] and k, v [B, L, KV, hd], row i at
//     position pos0 + i; writes the rotated q to q_out, the rotated k to
//     k_out and, where v_out is given, v to v_out (the prompt's own K
//     buffer, or the staging cache's rows pos0 .. pos0 + L - 1).
//   * act_mul_kernel: act(g) * u with act silu or tanh-gelu, rounded after
//     the activation and after the product.
//   add_rms_norm and act_mul take any number of rows: a decode step's one
//   token a sequence or a prompt's L.
//   Rounding and the order of each fp32 product and sum follow the chains'
//   separate PyTorch kernels (__fmul_rn and friends, so that nvcc does not
//   contract them into FMAs), and so does the order of each sum of squares
//   (PyTorch's reduction order, norm_lanes), so each kernel equals its
//   chain bit for bit.
//
// Bound: device memory, and at the decode step's shapes launch latency.  An
//   add-norm over minicpm-2b's [16, 2304] bf16 moves 0.3 MB (0.1 us at
//   3.35 TB/s); the rotary write of its 36 + 36 heads at hd 64 about 0.2
//   MB.  What costs is the number of launches and the gaps between them, so
//   each kernel is one launch and takes its indices and angles from the
//   device: no host read, and the step stays capturable in a CUDA graph.
//   In an eager prefill each launch is also host time (8-15 us of dispatch
//   a PyTorch op), so a prompt layer's glue is three kinds of launch, not
//   dozens; a 2000-row minicpm-2b prompt's rotary pass moves 37 MB, 11 us.
//
// Design:
//   * add_rms_norm: one block of 256 threads a row; 16-byte vectors where
//     the row and pointers allow it.  Pass 1 forms and stores the rounded
//     sum and puts its squares in shared memory; the block adds them in the
//     order of PyTorch's own CUDA reduction for mean(dim=-1) (Reduce.cuh in
//     torch 2.11: as many lanes a row as its setReduceConfig gives, four
//     accumulators a lane over groups of 4 from d = 128, then
//     block_x_reduce's tree; ordered_sum, the lanes from norm_lanes on the
//     host), so the norm equals rms_norm's bit for bit at any number of
//     rows, and the loads keep every thread busy; pass 2 re-reads the sum
//     each thread stored and writes the norm.
//   * rope_kv_write: one warp a head, q heads then k heads of every
//     sequence; lane i holds the pairs (i + 32 t, i + 32 t + hd / 2), so hd
//     up to 256 fits in registers; the qk norm's sum of squares re-reads
//     the head in PyTorch's order (head_sum_sq).  A k head's warp also
//     copies its v head.  The frequencies come from a
//     [hd / 2] fp32 table built once (ops.rope_table) with rope's own
//     expression.  rope_kv_prefill runs the same per-head code
//     (rope_head) with a warp for each head of each row.
//   * act_mul: one thread a 16-byte vector of g and u.

#include "vec.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNormMaxThreads = 512;   // PyTorch's reduction blocks
constexpr int kNormThreads = 256;      // add_rms_norm: one block a row
constexpr int kNormMaxShared = 227 * 1024;   // its squares: d <= 58112
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

// s * r * (1 + w): rms_norm's two fp32 products.
__device__ __forceinline__ float scale(float s, float r, float w) {
  return __fmul_rn(__fmul_rn(s, r), __fadd_rn(1.f, w));
}

// The sum of sq[0 .. d) (in shared memory), in thread 0, in the order in
// which PyTorch's CUDA reduction (ATen/native/cuda/Reduce.cuh) sums a
// contiguous fp32 row of d for mean(dim=-1): `lanes` lanes (norm_lanes,
// on the host), each with four accumulators; vec (d >= 128): lane l
// takes groups of 4 at head + 4 * (l + lanes * j), the head's elements (a
// row whose fp32 start is `shift` elements past a 16-byte boundary) and the
// tail into accumulator 0 of lanes shift .. 3 and 0 .. tail - 1; else
// element l + lanes * k into accumulator k % 4 (input_vectorized_
// thread_reduce_impl, thread_reduce_impl).  The lanes' sums then meet as in
// block_x_reduce: through shared memory down to 32, then warp shuffles with
// offsets 16, 8, 4, 2, 1.  A thread of the block stands for lanes t and t +
// kNormThreads where lanes exceeds the block.
template <bool kVec>
__device__ __forceinline__ float ordered_sum(const float* sq, float* part,
                                             int d, int lanes, int shift) {
  const int t = threadIdx.x;
  const int head = kVec && shift > 0 ? 4 - shift : 0;
  auto lane_sum = [&](int l) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (l < lanes) {
      if constexpr (kVec) {
        if (shift > 0 && l >= shift && l < 4) acc[0] = sq[l - shift];
        const int end = d - head;
        // groups g = l + lanes * j with 4 g + 3 < end, four loads at a
        // time ahead of their sums
        const int groups = end / 4 > l ? (end / 4 - l + lanes - 1) / lanes : 0;
        const int step = 4 * lanes;
        const float* at = sq + head + 4 * l;
        auto group = [&](const float* g, float* q) {
          if (head == 0) {   // one 16-byte load: no bank conflicts
            const float4 f = *reinterpret_cast<const float4*>(g);
            q[0] = f.x, q[1] = f.y, q[2] = f.z, q[3] = f.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) q[i] = g[i];
          }
        };
        int j = 0;
        for (; j + 4 <= groups; j += 4, at += 4 * step) {
          float q[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) group(at + u * step, q[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], q[u][i]);
        }
        for (; j < groups; ++j, at += step) {
          float q[4];
          group(at, q);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], q[i]);
        }
        const int tail = end % 4;
        if (l < tail) acc[0] = __fadd_rn(acc[0], sq[head + end - tail + l]);
      } else {   // element l + lanes * k into accumulator k % 4
        for (int e = l; e < d; e += 4 * lanes)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (e + i * lanes < d) acc[i] = __fadd_rn(acc[i], sq[e + i * lanes]);
      }
    }
    return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  };
  // lanes past the block: lane t + kNormThreads joins lane t first, as
  // block_x_reduce's first step does (lanes <= 2 * kNormThreads; the sums
  // are not negative, so 0 + s is s)
  float v = 0.f;
#pragma unroll 1
  for (int l = t; l < lanes || l == t; l += kNormThreads)
    v = __fadd_rn(v, lane_sum(l));
  const int width = lanes < kNormThreads ? lanes : kNormThreads;
  if (width > 32) {
    part[t] = v;
    for (int off = width / 2; off >= 32; off >>= 1) {
      __syncthreads();
      if (t < off) {
        v = __fadd_rn(v, part[t + off]);
        part[t] = v;
      }
    }
  }
  for (int off = (width < 32 ? width : 32) / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// One block of kNormThreads a row.  Pass 1 forms the rounded sum in 16-byte
// vectors where the row and pointers allow them, stores it and puts its
// squares in shared memory; ordered_sum adds them in PyTorch's order, so the
// norm equals rms_norm's bit for bit; pass 2 re-reads the sum each thread
// stored and writes the norm.
template <typename T, int V, bool kVec>
__global__ void __launch_bounds__(kNormThreads)
add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ w, T* sum, T* __restrict__ out,
                    int d, float eps, float alpha, int lanes) {
  extern __shared__ __align__(16) float sq[];   // [d]
  __shared__ float part[kNormThreads];
  __shared__ float total;
  const size_t base = (size_t)blockIdx.x * d;
  x += base;
  out += base;
  if (y != nullptr) {
    y += base;
    sum += base;
  }
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
    if constexpr (V == 1) {
      sq[i] = __fmul_rn(a[0], a[0]);
    } else {   // 16-byte stores: few bank conflicts
#pragma unroll
      for (int k = 0; k < V; k += 4)
        *reinterpret_cast<float4*>(sq + i + k) = make_float4(
            __fmul_rn(a[k], a[k]), __fmul_rn(a[k + 1], a[k + 1]),
            __fmul_rn(a[k + 2], a[k + 2]), __fmul_rn(a[k + 3], a[k + 3]));
    }
  }
  __syncthreads();
  const float ss = ordered_sum<kVec>(sq, part, d, lanes, (int)(base % 4));
  if (threadIdx.x == 0) total = ss;
  __syncthreads();
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, 1.f / (float)d), eps));
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

// The sum of squares of one head's hd values at src, in every lane of the
// warp, in the order of PyTorch's reduction for rms_norm over hd on its rows
// of heads (lanes and vec: norm_lanes of those rows; at hd <= 256 at most
// 64 lanes, a lane of the warp standing for lanes l and l + 32 of 64, which
// block_x_reduce adds first).
template <typename T>
__device__ __forceinline__ float head_sum_sq(const T* src, int hd, int lanes,
                                             int vec, int lane) {
  auto part = [&](int vl) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    auto sq = [&](int e, int k) {
      const float x = to_float(src[e]);
      acc[k] = __fadd_rn(acc[k], __fmul_rn(x, x));
    };
    if (vl < lanes) {
      if (vec) {
        for (int g = vl; 4 * g + 3 < hd; g += lanes)
#pragma unroll
          for (int i = 0; i < 4; ++i) sq(4 * g + i, i);
        if (vl < hd % 4) sq(hd - hd % 4 + vl, 0);
      } else {   // element vl + lanes * k into accumulator k % 4
        for (int e = vl; e < hd; e += 4 * lanes)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (e + i * lanes < hd) sq(e + i * lanes, i);
      }
    }
    return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  };
  float v = part(lane);
  if (lanes > 32) v = __fadd_rn(v, part(lane + 32));
  for (int off = min(lanes, 32) / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return __shfl_sync(0xffffffffu, v, 0);
}

// One head of hd values at src (hd / 2 pairs, lane i holding pairs i + 32 t):
// rms_norm'd by nw where it is not null (rounded to T; lanes and vec set
// PyTorch's order of its sum: norm_lanes of the rows of such heads), rotated
// at position pos
// by the frequency table freq (not at all where it is null: NoPE), stored to
// dst.  Every lane of the warp calls it with the same head.
template <typename T>
__device__ __forceinline__ void rope_head(const T* src, const T* nw,
                                          int lanes, int vec,
                                          const float* freq, int pos, int hd,
                                          float eps, T* dst, int lane) {
  const int half = hd / 2;
  float x1[kMaxPairs], x2[kMaxPairs];
#pragma unroll
  for (int t = 0; t < kMaxPairs; ++t) {
    const int j = lane + 32 * t;
    x1[t] = x2[t] = 0.f;
    if (j < half) {
      x1[t] = to_float(src[j]);
      x2[t] = to_float(src[j + half]);
    }
  }
  if (nw != nullptr) {   // the same for the whole warp
    const float r = rsqrtf(__fadd_rn(
        __fmul_rn(head_sum_sq(src, hd, lanes, vec, lane), 1.f / (float)hd),
        eps));
#pragma unroll
    for (int t = 0; t < kMaxPairs; ++t) {
      const int j = lane + 32 * t;
      if (j < half) {
        x1[t] = round_as(scale(x1[t], r, to_float(nw[j])), T());
        x2[t] = round_as(scale(x2[t], r, to_float(nw[j + half])), T());
      }
    }
  }
  if (freq == nullptr) {   // NoPE: the (normed) head as it is
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
      sincosf(__fmul_rn(p, freq[j]), &sn, &cs);
      repro::store(dst + j, __fsub_rn(__fmul_rn(x1[t], cs),
                                      __fmul_rn(x2[t], sn)));
      repro::store(dst + j + half, __fadd_rn(__fmul_rn(x1[t], sn),
                                             __fmul_rn(x2[t], cs)));
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_head(const T* src, T* dst, int hd,
                                          int lane) {
  for (int j = lane; j < hd; j += 32) dst[j] = src[j];
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
  int q_lanes, k_lanes, norm_vec;   // norm_lanes of the B * H and B * KV heads
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
  int pos = a.context_lens[b] - 1;
  if (a.ring > 0) pos = max(pos, 0);
  if (h < a.H) {
    const size_t at = ((size_t)b * a.H + h) * a.hd;
    rope_head(static_cast<const T*>(a.q) + at,
              static_cast<const T*>(a.q_norm), a.q_lanes, a.norm_vec, a.freq,
              pos, a.hd, a.eps, static_cast<T*>(a.q_out) + at, lane);
    return;
  }
  const int kvh = h - a.H;
  const int row = a.ring > 0 ? pos % a.ring : pos;
  if (row < 0) return;   // a paged row of length 0 has no slot
  const int pg = a.tables[(size_t)b * a.table_stride + row / a.page];
  const size_t off = (((size_t)pg * a.page + row % a.page) * a.KV + kvh)
                     * a.hd;
  const size_t at = ((size_t)b * a.KV + kvh) * a.hd;
  copy_head(static_cast<const T*>(a.v) + at, static_cast<T*>(a.v_pages) + off,
            a.hd, lane);
  rope_head(static_cast<const T*>(a.k) + at, static_cast<const T*>(a.k_norm),
            a.k_lanes, a.norm_vec, a.freq, pos, a.hd, a.eps,
            static_cast<T*>(a.k_pages) + off, lane);
}

struct RopePrefillArgs {
  const void* q;        // [B, L, H, hd]
  const void* k;        // [B, L, KV, hd]
  const void* v;        // [B, L, KV, hd], read where v_out is not null
  const void* q_norm;   // [hd] or null
  const void* k_norm;   // [hd] or null
  const float* freq;    // [hd / 2], or null: no rotation
  void* q_out;          // [B, L, H, hd]
  void* k_out;          // row i of batch b at b * out_stride + i * KV * hd
  void* v_out;          // the same layout, or null: v is not copied
  long long out_stride;
  int B, L, H, KV, hd, pos0;
  int q_lanes, k_lanes, norm_vec;   // norm_lanes of the B*L*H and B*L*KV heads
  float eps;
};

// One warp a head of a row: the q heads, then the k heads, of each of the
// B * L rows; row i of a batch sits at position pos0 + i.
template <typename T>
__global__ void __launch_bounds__(kRopeWarps * 32)
rope_kv_prefill_kernel(RopePrefillArgs a) {
  const int lane = threadIdx.x % 32;
  const int heads = a.H + a.KV;
  const long long gw =
      (long long)blockIdx.x * kRopeWarps + threadIdx.x / 32;
  if (gw >= (long long)a.B * a.L * heads) return;
  const long long r = gw / heads;   // b * L + i
  const int h = (int)(gw % heads);
  const int b = (int)(r / a.L), i = (int)(r % a.L);
  if (h < a.H) {
    const size_t at = ((size_t)r * a.H + h) * a.hd;
    rope_head(static_cast<const T*>(a.q) + at,
              static_cast<const T*>(a.q_norm), a.q_lanes, a.norm_vec, a.freq,
              a.pos0 + i, a.hd, a.eps, static_cast<T*>(a.q_out) + at, lane);
    return;
  }
  const int kvh = h - a.H;
  const size_t at = ((size_t)r * a.KV + kvh) * a.hd;
  const size_t off =
      (size_t)b * a.out_stride + ((size_t)i * a.KV + kvh) * a.hd;
  if (a.v_out != nullptr)
    copy_head(static_cast<const T*>(a.v) + at, static_cast<T*>(a.v_out) + off,
              a.hd, lane);
  rope_head(static_cast<const T*>(a.k) + at, static_cast<const T*>(a.k_norm),
            a.k_lanes, a.norm_vec, a.freq, a.pos0 + i, a.hd, a.eps,
            static_cast<T*>(a.k_out) + off, lane);
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

// PyTorch's block width for mean(dim=-1) over a contiguous fp32 [rows, d]
// (setReduceConfig in Reduce.cuh): groups of 4 ("vectorize along input")
// from d = 128; block_width and block_height from the powers of two at or
// below the vectors a row and the rows, 512 threads at most.
int last_pow2(long long n) {
  int p = 1;
  while ((long long)p * 2 <= n) p *= 2;
  return p;
}

void norm_lanes(long long rows, int d, int* lanes, int* vec) {
  *vec = d >= 128;
  const long long dim0 = *vec ? d / 4 : d;
  const int d0 = dim0 < kNormMaxThreads ? last_pow2(dim0) : kNormMaxThreads;
  const int d1 = rows < kNormMaxThreads ? last_pow2(rows) : kNormMaxThreads;
  const int bw = d0 < 32 ? d0 : 32;
  const int bh = d1 < kNormMaxThreads / bw ? d1 : kNormMaxThreads / bw;
  *lanes = d0 < kNormMaxThreads / bh ? d0 : kNormMaxThreads / bh;
}

template <typename T, int V, bool kVec>
int launch_add_rms_norm(const T* x, const T* y, const T* w, T* sum, T* out,
                        int rows, int d, float eps, float alpha, int lanes,
                        cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > kNormMaxShared) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        add_rms_norm_kernel<T, V, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  add_rms_norm_kernel<T, V, kVec><<<rows, kNormThreads, smem, stream>>>(
      x, y, w, sum, out, d, eps, alpha, lanes);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_add_rms_norm(const void* x, const void* y, const void* w, void* sum,
                        void* out, int rows, int d, float eps, float alpha,
                        cudaStream_t stream) {
  int lanes, vec;
  norm_lanes(rows, d, &lanes, &vec);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* wt = static_cast<const T*>(w);
  T* st = static_cast<T*>(sum);
  T* ot = static_cast<T*>(out);
  return vec ? launch_add_rms_norm<T, V, true>(xt, yt, wt, st, ot, rows, d,
                                                eps, alpha, lanes, stream)
             : launch_add_rms_norm<T, V, false>(xt, yt, wt, st, ot, rows, d,
                                                 eps, alpha, lanes, stream);
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
  int q_lanes, k_lanes, vec;
  norm_lanes((long long)B * H, hd, &q_lanes, &vec);
  norm_lanes((long long)B * KV, hd, &k_lanes, &vec);
  RopeArgs a{q, k, v, q_norm, k_norm, static_cast<const float*>(freq),
             static_cast<const int*>(context_lens),
             static_cast<const int*>(tables), q_out, k_pages, v_pages,
             B, H, KV, hd, page, table_stride, ring, q_lanes, k_lanes, vec,
             eps};
  const int warps = B * (H + KV);
  const dim3 grid((warps + kRopeWarps - 1) / kRopeWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    rope_kv_write_kernel<bf16><<<grid, kRopeWarps * 32, 0, s>>>(a);
  else
    rope_kv_write_kernel<float><<<grid, kRopeWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// q, k, v: [B, L, ., hd] contiguous; k_out / v_out rows of KV * hd, batches
// out_stride elements apart (v_out null: v is not copied).
extern "C" int rope_kv_prefill_launch(const void* q, const void* k,
                                      const void* v, const void* q_norm,
                                      const void* k_norm, const void* freq,
                                      void* q_out, void* k_out, void* v_out,
                                      long long out_stride, int B, int L,
                                      int H, int KV, int hd, int pos0,
                                      float eps, int is_bf16, void* stream) {
  if (B < 1 || L < 1 || H < 1 || KV < 1 || hd < 2 || hd % 2 ||
      hd > 64 * kMaxPairs || pos0 < 0 || out_stride < (long long)L * KV * hd)
    return (int)cudaErrorInvalidValue;
  int q_lanes, k_lanes, vec;
  norm_lanes((long long)B * L * H, hd, &q_lanes, &vec);
  norm_lanes((long long)B * L * KV, hd, &k_lanes, &vec);
  RopePrefillArgs a{q, k, v, q_norm, k_norm, static_cast<const float*>(freq),
                    q_out, k_out, v_out, out_stride, B, L, H, KV, hd, pos0,
                    q_lanes, k_lanes, vec, eps};
  const long long warps = (long long)B * L * (H + KV);
  const dim3 grid((unsigned)((warps + kRopeWarps - 1) / kRopeWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    rope_kv_prefill_kernel<bf16><<<grid, kRopeWarps * 32, 0, s>>>(a);
  else
    rope_kv_prefill_kernel<float><<<grid, kRopeWarps * 32, 0, s>>>(a);
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
