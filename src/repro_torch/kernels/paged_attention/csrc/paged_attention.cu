// Paged decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
//   _paged_kernel / paged_attention_pallas (Pallas TPU kernel).
//
// Computes: one query token per sequence, q [B, H, hd], attends over the K/V
//   pages [P, page, KV, hd] that its row of block_tables [B, n_pages] names,
//   up to context_lens[b] tokens.  Query head h reads KV head h / G, G = H/KV.
//   Online softmax in fp32.  A sequence with ctx = 0 gets zeros, as the
//   Pallas kernel does (l clamped to 1e-30).
//
// Bound: device memory.  A launch reads sum(ctx) * KV * hd K and V elements
//   once each and does 4 * G flops per element pair: at G = 4 in bf16 that
//   is about 4 flops per byte, far below the ~295 flops per byte at which
//   the tensor cores, not the memory, would limit Hopper.
//
// Design: one block per (kv head, sequence), so the G query rows that share
//   a KV head read each K/V row once.  The block keeps those rows and their
//   running (m, l, acc) in shared memory, walks the sequence in tiles of 64
//   tokens, and only the tiles below ctx are visited.  A memory-bound kernel
//   needs many bytes in flight: each tile first resolves its tokens' page
//   rows into shared memory, then every thread issues all of its 16-byte K
//   and V loads of the tile into registers before it stores any of them
//   (up to 32 KB in flight per block).  Scores go thread per (query row,
//   token) over a padded K tile, the softmax update warp per query row, and
//   P.V thread per (row, dim).  Left for later work: split the sequence
//   over several blocks (flash-decoding) so that a small batch fills the
//   132 SMs, overlap of one tile's loads with the last one's arithmetic,
//   and tensor-core products.

#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // tokens per tile
constexpr int kLoads = 8;   // 16-byte loads per thread per tile and tensor:
                            // kTile * 128 * 4 bytes / 16 / kThreads at most

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, T* __restrict__ out,
                    int H, int KV, int hd, int page, int n_pages, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int ldk = hd + 1;  // padded K rows: thread-per-token reads spread banks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                 // [G][hd]
  float* acc = qs + G * hd;         // [G][hd]
  float* ks = acc + G * hd;         // [kTile][ldk]
  float* vs = ks + kTile * ldk;     // [kTile][hd]
  float* sc = vs + kTile * hd;      // [G][kTile] scores, then probabilities
  float* m = sc + G * kTile;        // [G] running max
  float* l = m + G;                 // [G] running denominator
  float* alpha = l + G;             // [G] rescale of this tile
  long long* rows = reinterpret_cast<long long*>(alpha + G + (G & 1));  // [kTile]

  // the G query rows of this KV head are contiguous in q
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = repro::to_float(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const int ctx = max(0, min(context_lens[b], n_pages * page));
  const int* bt = block_tables + (size_t)b * n_pages;
  constexpr int vec = 16 / (int)sizeof(T);
  const int chunks = hd / vec;

  for (int t0 = 0; t0 < ctx; t0 += kTile) {
    const int n = min(kTile, ctx - t0);
    // element offset of each token's K/V row for this KV head
    for (int t = tid; t < n; t += kThreads) {
      const int pos = t0 + t;
      rows[t] = ((long long)bt[pos / page] * page + pos % page) * KV * hd +
                (long long)kvh * hd;
    }
    __syncthreads();  // rows ready; the previous tile's P.V is done

    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < n * chunks) {
        const int t = i / chunks, c = i - t * chunks;
        const long long off = rows[t] + c * vec;
        kr[j] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[j] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < n * chunks) {
        const int t = i / chunks, c = i - t * chunks;
        repro::widen16(kr[j], ks + t * ldk + c * vec, T());
        repro::widen16(vr[j], vs + t * hd + c * vec, T());
      }
    }
    __syncthreads();

    for (int i = tid; i < G * n; i += kThreads) {
      const int g = i / n, t = i - g * n;
      const float* qg = qs + g * hd;
      const float* kt = ks + t * ldk;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int d = 0; d < hd; d += 4) {
        s0 = fmaf(qg[d], kt[d], s0);
        s1 = fmaf(qg[d + 1], kt[d + 1], s1);
        s2 = fmaf(qg[d + 2], kt[d + 2], s2);
        s3 = fmaf(qg[d + 3], kt[d + 3], s3);
      }
      sc[g * kTile + t] = ((s0 + s1) + (s2 + s3)) * scale;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mt = -INFINITY;
      for (int t = lane; t < n; t += 32) mt = fmaxf(mt, sc[g * kTile + t]);
      mt = repro::warp_max(mt);
      const float m_new = fmaxf(m[g], mt);  // finite: the tile has n >= 1 tokens
      float ls = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(sc[g * kTile + t] - m_new);
        sc[g * kTile + t] = p;
        ls += p;
      }
      ls = repro::warp_sum(ls);
      if (lane == 0) {
        const float a = expf(m[g] - m_new);  // 0 on the first tile
        alpha[g] = a;
        l[g] = l[g] * a + ls;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* p = sc + g * kTile;
      float a = acc[i] * alpha[g];
      for (int t = 0; t < n; ++t) a = fmaf(p[t], vs[t * hd + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    repro::store(ob + i, acc[i] / fmaxf(l[i / hd], 1e-30f));
  }
}

size_t smem_bytes(int G, int hd) {
  const size_t floats = 2 * (size_t)G * hd + (size_t)kTile * (hd + 1) +
                        (size_t)kTile * hd + (size_t)G * kTile + 3 * (size_t)G +
                        (G & 1);
  return floats * sizeof(float) + kTile * sizeof(long long);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* context_lens, void* out,
           int B, int H, int KV, int hd, int page, int n_pages,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, hd);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.0f / sqrtf((float)hd);
  paged_decode_kernel<T><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<T*>(out), H, KV, hd,
      page, n_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); a G * hd too
// large for one block's shared memory is refused by cudaFuncSetAttribute.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* context_lens, void* out,
                                      int B, int H, int KV, int hd, int page,
                                      int n_pages, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                 context_lens, out, B, H, KV, hd, page,
                                 n_pages, s);
  return launch<float>(q, k_pages, v_pages, block_tables, context_lens, out,
                       B, H, KV, hd, page, n_pages, s);
}
