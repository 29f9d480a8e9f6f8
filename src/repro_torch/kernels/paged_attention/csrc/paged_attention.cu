// Paged decode attention for Hopper (sm_90a): flash-decoding in two passes.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
//   _paged_kernel / paged_attention_pallas (Pallas TPU kernel).
//
// Computes: one query token per sequence, q [B, H, hd], attends over the K/V
//   pages [P, page, KV, hd] that its row of block_tables [B, n_pages] names,
//   up to context_lens[b] tokens.  Query head h reads KV head h / G, G = H/KV
//   (1..8); hd is a multiple of 16 up to 128, or 256 (gemma3-12b).  Online
//   softmax in fp32.  A sequence with ctx = 0 gets zeros, as the Pallas
//   kernel does.  The same call reads a window layer's per-slot ring: its
//   table names the slot's own pages, its length is min(ctx, ring size).
//   With softcap c > 0 each scaled score s becomes tanh(s / c) * c before
//   the mask and the softmax, as the JAX model's _sdpa caps it
//   (src/repro/models/layers.py:119-128; the Pallas kernel has no cap).
//
// Bound: device memory.  A launch reads sum(ctx) * KV * hd K and V elements
//   once each and does 4 * G flops per element pair: at G = 4 in bf16 about
//   4 flops per byte, against the ~295 at which Hopper's tensor cores, not
//   its 3.35 TB/s, would be the limit.  So the kernel has to keep enough
//   bytes in flight on every SM, whatever the batch, and spend few
//   instructions per byte.
//
// Design:
//   * Split each sequence over blocks.  Pass 1 runs one block per (KV head,
//     sequence, split); a split is a whole number of 64-token tiles, and the
//     host picks the split count from shapes alone (ops.partition: about two
//     blocks per SM, splits of at least 256 tokens), so B = 1 fills the card
//     and the wrapper never reads context_lens.  A split wholly past ctx
//     writes m = -inf, l = 0 and exits.  Each block writes its G rows'
//     running max m (log2 units), sum l and unnormalised acc [G][hd] to an
//     fp32 workspace.  Pass 2 (one block per (query head, sequence)) merges
//     o = sum_s 2^(m_s - m*) acc_s / sum_s 2^(m_s - m*) l_s over the
//     ceil(ctx / split) splits that hold tokens, and gives zeros when there
//     are none: it never reads an empty split and never forms -inf - -inf.
//   * Keep bytes in flight.  Each block streams its tiles through a ring of
//     shared-memory stages in the storage type (bf16 stays bf16), filled by
//     16-byte cp.async.cg copies under commit/wait groups: while tile i is
//     computed, the next kStages - 1 tiles are in flight.  The copies run
//     in row order, so a warp's copies cover whole 256-byte rows (hd 128,
//     bf16).  Each tile's page rows are resolved into shared memory a tile
//     ahead, from block-table entries loaded a tile before that, so no copy
//     waits on a block-table load.  Rows past ctx are zero-filled (src-size
//     0) and never read from device memory.  One barrier per tile guards
//     the ring.
//   * Keep the arithmetic off the critical path.  bf16 runs both products on
//     the tensor cores with mma.sync.m16n8k16: each warp takes 16 tokens of
//     a 64-token tile, S = Q K^T with the G query rows padded to 16 (Q held
//     as A fragments in registers, K read by ldmatrix), the online softmax
//     on S's accumulator fragments, then O += P V with P packed to bf16 A
//     fragments and V read by ldmatrix.trans.  K/V rows are padded by 16
//     bytes in shared memory so that ldmatrix is conflict-free.  At hd 256
//     the same code holds a 64 x 256 fp32 output fragment per warp (128
//     registers a thread) and three stages of 64 rows of 264 bf16 (203 KB):
//     one block an SM.  fp32 stays on CUDA-core FMAs (the tensor cores
//     would round it to TF32): a half-warp per token up to hd 128, a warp
//     per token at hd 256, each lane holding 8 elements of the G query rows
//     and of G accumulators in registers; each group takes 4 tokens of a
//     tile (32 tokens with half-warps, 16 with warps), so the registers and
//     the tile's bytes stay those of hd 128.  Every warp (bf16) or group
//     (fp32) keeps its own online softmax; their states merge once, at the
//     end of the block, through shared memory.
//   * The softcap is an argument of both pass-1 kernels (cap_mul > 0),
//     a branch every thread takes the same way: a call without a cap runs
//     no tanhf, and one build serves both (a template flag doubled the
//     library's kernels and its nvcc time).  The cap applies where a
//     token is in range, before its score joins the running max, and a
//     token past ctx stays -inf (tanh(-inf) * c is the finite -c, which
//     would weigh masked tokens and empty splits).  Scores stay in log2
//     units, so the merge pass is the same with or without a cap: the
//     bf16 kernel maps s to tanhf(s * scale / c) * c * log2e; the fp32
//     kernel scales q by scale / c in place of scale * log2e and maps
//     its dot products x to tanhf(x) * c * log2e (B2's cap_in / mul
//     split), each score once per group of lanes (cap_group).

#include <stdint.h>

#include "vec.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;    // 4 warps, both passes
constexpr int kSplitAlign = 64;  // splits are whole 64-token tiles: ops.TILE
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B for one m16n8k16 bf16 product.  A's rows 8..15 are zero (the G
// <= 8 query rows sit in rows 0..7), so its fragments a1 and a3 are 0.
__device__ __forceinline__ void mma_rows8(float (&d)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  const uint32_t z = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(z), "r"(a2), "r"(z), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A score x already multiplied by qk_mul, in log2 units: x itself without
// a cap (qk_mul = scale * log2e, cap_mul = 0); tanh(x) * c * log2e with
// cap c (qk_mul = scale / c, cap_mul = c * log2e).
__device__ __forceinline__ float capped(float x, float cap_mul) {
  return cap_mul > 0.f ? tanhf(x) * cap_mul : x;
}

// ---------------------------------------------------------------------------
// What both pass-1 kernels share: the split's token range, the K/V ring, and
// the merge of the block's partial softmax states.
// ---------------------------------------------------------------------------

// The tokens [start, end) of this block's split.  A split wholly past ctx
// writes m = -inf, l = 0 for its G rows and returns false.
__device__ __forceinline__ bool split_range(const int* context_lens,
                                            int n_pages, int page,
                                            int split_tokens, int G,
                                            float* ml, int& start,
                                            int& end) {
  const int ctx = max(0, min(context_lens[blockIdx.y], n_pages * page));
  start = blockIdx.z * split_tokens;
  end = min(start + split_tokens, ctx);
  if (start < end) return true;
  if (threadIdx.x < G) {
    ml[threadIdx.x] = -INFINITY;
    ml[G + threadIdx.x] = 0.f;
  }
  return false;
}

// Streams the split's K and V rows, kTile tokens a tile, into a ring of
// kStages shared-memory stages, each [K, V][kTile][ld] in the storage type.
// Calls body(tile, k_stage, v_stage) once per tile, in order, when the tile
// has landed.  The copies run in row order, so that each warp's 16-byte
// copies cover whole rows (a row of one KV head is hd contiguous elements).
// Their element offsets come from offs[kStages][kTile] in shared memory
// (-1 past ctx), which thread t < kTile fills for its token one tile ahead,
// from a block-table entry that it loaded one tile before that: no copy
// waits on a block-table load.
template <typename T, int kTile, int kStages, typename Body>
__device__ __forceinline__ void stream_tiles(
    T* ring, long long* offs, int ld, const T* k_pages, const T* v_pages,
    const int* bt, int KV, int hd, int page, int start, int end,
    Body&& body) {
  constexpr int vec = 16 / (int)sizeof(T);
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const int nch = hd / vec;  // 16-byte chunks per row
  const int tid = threadIdx.x;
  const long long row_stride = (long long)KV * hd;
  const T* kbase = k_pages + (size_t)blockIdx.x * hd;
  const T* vbase = v_pages + (size_t)blockIdx.x * hd;
  const int stage_elems = 2 * kTile * ld;

  auto page_of = [&](int tile) -> int {  // thread tid's token; -1 past ctx
    const int pos = start + tile * kTile + tid;
    return tid < kTile && pos < end ? bt[pos / page] : -1;
  };
  auto put = [&](int tile, int pg) {  // its element offset, for issue
    if (tid < kTile) {
      const int pos = start + tile * kTile + tid;
      offs[(tile % kStages) * kTile + tid] =
          pg < 0 ? -1 : ((long long)pg * page + pos % page) * row_stride;
    }
  };
  auto issue = [&](int tile) {
    T* ks = ring + (size_t)(tile % kStages) * stage_elems;
    const long long* off = offs + (tile % kStages) * kTile;
    for (int i = tid; i < kTile * nch; i += kThreads) {
      const int r = i / nch, ch = i - r * nch;
      const long long o = off[r];
      const long long src = (o < 0 ? 0 : o) + ch * vec;
      const int bytes = o < 0 ? 0 : 16;
      cp_async16(smem_u32(ks + r * ld + ch * vec), kbase + src, bytes);
      cp_async16(smem_u32(ks + (kTile + r) * ld + ch * vec), vbase + src,
                 bytes);
    }
  };

  int pg_pre[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) pg_pre[s] = s < n_tiles ? page_of(s) : -1;
#pragma unroll
  for (int s = 0; s < kStages; ++s) put(s, pg_pre[s]);
  int pg_next = kStages < n_tiles ? page_of(kStages) : -1;
  __syncthreads();  // offsets of tiles 0 .. kStages - 1 ready
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's landed; tile i - 1's stage is free
    const int nxt = i + kStages - 1;
    if (nxt < n_tiles) issue(nxt);
    cp_async_commit();
    // tile i's offset slot is free: fill it for tile nxt + 1, read by
    // issue() after the next barrier
    if (nxt + 1 < n_tiles) {
      put(nxt + 1, pg_next);
      pg_next = nxt + 2 < n_tiles ? page_of(nxt + 2) : -1;
    }
    const T* ks = ring + (size_t)(i % kStages) * stage_elems;
    body(i, ks, ks + kTile * ld);
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile read: the ring may be reused
}

// The block's nG groups (warps or half-warps) each kept a softmax over part
// of the split's tokens and wrote its m (log2 units) and l to sm_m[j][g],
// sm_l[j][g].  group_weight is 2^(m_j - m_blk) for group j's row g (0 for a
// group that saw no token; m_blk is finite, since group 0 holds the split's
// first token).  Each group writes its acc times that weight to
// red[j][g][hd]; write_partial sums them into the workspace.
__device__ __forceinline__ float group_weight(const float* sm_m, int nG, int G,
                                              int g, float m) {
  float mb = sm_m[g];
  for (int j = 1; j < nG; ++j) mb = fmaxf(mb, sm_m[j * G + g]);
  return ex2(m - mb);
}

__device__ __forceinline__ void write_partial(const float* red,
                                              const float* sm_m,
                                              const float* sm_l, int nG,
                                              int G, int hd, float* out_acc,
                                              float* ml) {
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    float a = 0.f;
    for (int j = 0; j < nG; ++j) a += red[(j * G + g) * hd + d];
    out_acc[i] = a;
  }
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mb = sm_m[g];
    for (int j = 1; j < nG; ++j) mb = fmaxf(mb, sm_m[j * G + g]);
    float lb = 0.f;
    for (int j = 0; j < nG; ++j)
      lb += sm_l[j * G + g] * ex2(sm_m[j * G + g] - mb);
    ml[g] = mb;
    ml[G + g] = lb;
  }
}

// ---------------------------------------------------------------------------
// Pass 1, bf16: tensor cores (mma.sync).  One block per (KV head, sequence,
// split); 64-token tiles, 16 tokens a warp.
// ---------------------------------------------------------------------------

constexpr int kMmaTile = 64;
constexpr int kMmaStages = 3;  // 3 x 34 KB at hd 128: two blocks an SM

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_split_mma_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k_pages,
                       const bf16* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int H, int KV, int page, int n_pages,
                       int split_tokens, float qk_mul, float cap_mul) {
  constexpr int LD = HD + 8;   // padded row: ldmatrix without conflicts
  constexpr int NK = HD / 16;  // k-steps of S = Q K^T
  constexpr int NN = HD / 8;   // n-tiles of O = P V
  constexpr int nG = kThreads / 32;
  const int G = H / KV;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const size_t part = ((size_t)b * KV + kvh) * gridDim.z + blockIdx.z;
  float* ml = ws_ml + part * 2 * G;  // [m[G], l[G]]
  int start, end;
  if (!split_range(context_lens, n_pages, page, split_tokens, G, ml, start,
                   end))
    return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = lane >> 2, qc = (lane & 3) * 2;  // fragment row, column

  // Q as A fragments: row qg (zero from G on), columns qc, qc + 1 of each
  // 8-column half of every k-step
  uint32_t qa[NK][2];
  const bf16* qrow = q + ((size_t)b * H + (size_t)kvh * G + qg) * HD;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    qa[k][0] = qg < G ? *reinterpret_cast<const uint32_t*>(qrow + k * 16 + qc)
                      : 0u;
    qa[k][1] = qg < G ? *reinterpret_cast<const uint32_t*>(qrow + k * 16 + 8 +
                                                           qc)
                      : 0u;
  }
  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m = -INFINITY, l = 0.f;  // row qg; l sums this lane's columns only

  // ldmatrix row addresses of this lane within the warp's 16 tokens
  const int k_tok = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_tok = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  long long* offs =
      reinterpret_cast<long long*>(ring + kMmaStages * 2 * kMmaTile * LD);
  stream_tiles<bf16, kMmaTile, kMmaStages>(
      ring, offs, LD, k_pages, v_pages, block_tables + (size_t)b * n_pages,
      KV, HD, page, start, end, [&](int i, const bf16* ks, const bf16* vs) {
        ks += warp * 16 * LD;
        vs += warp * 16 * LD;
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const uint32_t ka = smem_u32(ks + k_tok * LD + k_col);
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          uint32_t kb[4];
          ldsm_x4(kb, ka + k * 32);
          mma_rows8(s[0], qa[k][0], qa[k][1], kb[0], kb[1]);
          mma_rows8(s[1], qa[k][0], qa[k][1], kb[2], kb[3]);
        }
        // s[n][e], e < 2: row qg, token 8n + qc + e of the warp's 16
        const int t0 = start + i * kMmaTile + warp * 16 + qc;
        float mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[n][e] = t0 + 8 * n + e < end
                          ? capped(s[n][e] * qk_mul, cap_mul)
                          : -INFINITY;
            mt = fmaxf(mt, s[n][e]);
          }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        // m stays -inf until the warp has seen a token; base keeps
        // -inf - -inf away
        const float m_new = fmaxf(m, mt);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2(m - base);
        float p[2][2], ls = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[n][e] = ex2(s[n][e] - base);
            ls += p[n][e];
          }
        l = l * alpha + ls;
        m = m_new;
        const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]);
        const uint32_t pa2 = pack_bf16(p[1][0], p[1][1]);
        const uint32_t va = smem_u32(vs + v_tok * LD + v_col);
#pragma unroll
        for (int n2 = 0; n2 < NN / 2; ++n2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, va + n2 * 32);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            o[2 * n2][e] *= alpha;
            o[2 * n2 + 1][e] *= alpha;
          }
          mma_rows8(o[2 * n2], pa0, pa2, vb[0], vb[1]);
          mma_rows8(o[2 * n2 + 1], pa0, pa2, vb[2], vb[3]);
        }
      });

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* red = reinterpret_cast<float*>(smem_raw);  // [nG][G][HD]
  float* sm_m = red + nG * G * HD;                  // [nG][G]
  float* sm_l = sm_m + nG * G;                      // [nG][G]
  if (qc == 0 && qg < G) {
    sm_m[warp * G + qg] = m;
    sm_l[warp * G + qg] = l;
  }
  __syncthreads();
  if (qg < G) {
    const float w = group_weight(sm_m, nG, G, qg, m);
    float* dst = red + (warp * G + qg) * HD + qc;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      dst[n * 8] = o[n][0] * w;
      dst[n * 8 + 1] = o[n][1] * w;
    }
  }
  __syncthreads();
  write_partial(red, sm_m, sm_l, nG, G, HD, ws_acc + part * G * HD, ml);
}

// ---------------------------------------------------------------------------
// Pass 1, fp32: CUDA-core FMAs.  One block per (KV head, sequence, split);
// LANES lanes per token (16 up to hd 128, 32 at hd 256), 4 tokens a group
// per tile.
// ---------------------------------------------------------------------------

constexpr int kFmaStages = 3;  // 3 x 32 KB at hd 128: two blocks an SM
constexpr int kPerGroup = 4;   // tokens a group takes per tile

template <int LANES>
struct FmaCfg {
  static constexpr int kGroups = kThreads / LANES;      // half-warps or warps
  static constexpr int kTile = kGroups * kPerGroup;     // 32 or 16 tokens
};

// The 8 elements of a row that lane c owns: 16-byte chunks c and c + LANES
// of 4 floats each; chunks past the row are 0.
template <int LANES>
__device__ __forceinline__ void lane_row(const float* row, int c, int nch,
                                         float (&x)[8]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ch = c + LANES * k;
    if (ch < nch) {
      repro::load16(row + ch * 4, x + k * 4);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[k * 4 + e] = 0.f;
    }
  }
}

// Sum over the LANES lanes of a group (every lane gets the sum).
template <int LANES>
__device__ __forceinline__ float group_sum(float a) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// The U x G scores that every lane of a group holds, capped: each score's
// tanhf once per group (lane c takes scores c, c + LANES, ...), then
// shuffled back to every lane of the group.  tanhf costs more than the
// score's 8 FMAs a lane, so LANES lanes each capping every score would
// double the pass at G = 8.
template <int U, int G, int LANES>
__device__ __forceinline__ void cap_group(float (&s)[U][G], int c,
                                          float cap_mul) {
  constexpr int N = U * G, NT = (N + LANES - 1) / LANES;
  float t[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float x = 0.f;
#pragma unroll
    for (int i = j * LANES; i < N && i < (j + 1) * LANES; ++i)
      if (i - j * LANES == c) x = s[i / G][i % G];
    t[j] = capped(x, cap_mul);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    s[i / G][i % G] = __shfl_sync(0xffffffffu, t[i / LANES], i % LANES,
                                  LANES);
}

template <int G, int LANES>
__global__ void __launch_bounds__(kThreads)
paged_split_fma_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pages,
                       const float* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int H, int KV, int hd, int page, int n_pages,
                       int split_tokens, float qk_mul, float cap_mul) {
  constexpr int kGroups = FmaCfg<LANES>::kGroups;
  constexpr int kTile = FmaCfg<LANES>::kTile;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const size_t part = ((size_t)b * KV + kvh) * gridDim.z + blockIdx.z;
  float* ml = ws_ml + part * 2 * G;  // [m[G], l[G]]
  int start, end;
  if (!split_range(context_lens, n_pages, page, split_tokens, G, ml, start,
                   end))
    return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int grp = threadIdx.x / LANES, c = threadIdx.x % LANES;
  const int nch = hd / 4;

  // the G query rows of this KV head are contiguous in q
  float qr[G][8], acc[G][8], m[G], l[G];
  const float* qb = q + ((size_t)b * H + (size_t)kvh * G) * hd;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lane_row<LANES>(qb + g * hd, c, nch, qr[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[g][e] *= qk_mul;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  long long* offs =
      reinterpret_cast<long long*>(ring + kFmaStages * 2 * kTile * hd);
  stream_tiles<float, kTile, kFmaStages>(
      ring, offs, hd, k_pages, v_pages, block_tables + (size_t)b * n_pages,
      KV, hd, page, start, end, [&](int i, const float* ks, const float* vs) {
        const int t0 = start + i * kTile;
        float s[kPerGroup][G];
#pragma unroll
        for (int u = 0; u < kPerGroup; ++u) {
          float kx[8];
          lane_row<LANES>(ks + (grp + u * kGroups) * hd, c, nch, kx);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float a = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) a = fmaf(qr[g][e], kx[e], a);
            s[u][g] = a;
          }
        }
#pragma unroll
        for (int u = 0; u < kPerGroup; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g) s[u][g] = group_sum<LANES>(s[u][g]);
        if (cap_mul > 0.f) cap_group<kPerGroup, G, LANES>(s, c, cap_mul);
#pragma unroll
        for (int u = 0; u < kPerGroup; ++u) {
          const bool valid = t0 + grp + u * kGroups < end;
#pragma unroll
          for (int g = 0; g < G; ++g) s[u][g] = valid ? s[u][g] : -INFINITY;
        }
        // m stays -inf until the group has seen a token; base keeps
        // -inf - -inf away
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float mt = s[0][g];
#pragma unroll
          for (int u = 1; u < kPerGroup; ++u) mt = fmaxf(mt, s[u][g]);
          const float m_new = fmaxf(m[g], mt);
          const float base = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = ex2(m[g] - base);
          float ls = 0.f;
#pragma unroll
          for (int u = 0; u < kPerGroup; ++u) {
            s[u][g] = ex2(s[u][g] - base);
            ls += s[u][g];
          }
          l[g] = l[g] * alpha + ls;
          m[g] = m_new;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
        }
#pragma unroll
        for (int u = 0; u < kPerGroup; ++u) {
          float vx[8];
          lane_row<LANES>(vs + (grp + u * kGroups) * hd, c, nch, vx);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[g][e] = fmaf(s[u][g], vx[e], acc[g][e]);
        }
      });

  float* red = reinterpret_cast<float*>(smem_raw);  // [kGroups][G][hd]
  float* sm_m = red + kGroups * G * hd;             // [kGroups][G]
  float* sm_l = sm_m + kGroups * G;                 // [kGroups][G]
  if (c == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[grp * G + g] = m[g];
      sm_l[grp * G + g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float w = group_weight(sm_m, kGroups, G, g, m[g]);
    float* dst = red + (grp * G + g) * hd;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ch = c + LANES * k;
      if (ch < nch) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[ch * 4 + e] = acc[g][k * 4 + e] * w;
      }
    }
  }
  __syncthreads();
  write_partial(red, sm_m, sm_l, kGroups, G, hd, ws_acc + part * G * hd, ml);
}

// ---------------------------------------------------------------------------
// Pass 2: one block per (query head, sequence) merges its splits.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_ml,
                   const int* __restrict__ context_lens, T* __restrict__ out,
                   int H, int KV, int hd, int n_split, int split_tokens,
                   int n_tokens) {
  extern __shared__ float msm[];
  float* w = msm;             // [n_split]: m, then the split's weight
  float* ls = msm + n_split;  // [n_split]: l
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / KV, kvh = h / G, g = h - kvh * G;
  const size_t part0 = ((size_t)b * KV + kvh) * n_split;
  // splits 0 .. n_act - 1 hold tokens (m finite); the rest are empty
  const int ctx = max(0, min(context_lens[b], n_tokens));
  const int n_act = (ctx + split_tokens - 1) / split_tokens;
  const float* ml = ws_ml + part0 * 2 * G + g;  // m_s at [2 G s], l_s + G
  for (int s = threadIdx.x; s < n_act; s += kThreads) {
    w[s] = ml[2 * G * s];
    ls[s] = ml[2 * G * s + G];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < n_act; ++s) mx = fmaxf(mx, w[s]);
  float den = 0.f;
  for (int s = 0; s < n_act; ++s) den += ex2(w[s] - mx) * ls[s];
  __syncthreads();  // every thread has read the m's
  for (int s = threadIdx.x; s < n_act; s += kThreads)
    w[s] = ex2(w[s] - mx) / den;
  __syncthreads();
  const float* acc = ws_acc + part0 * G * hd + (size_t)g * hd;
  T* ob = out + ((size_t)b * H + h) * hd;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;  // stays 0 when ctx = 0
#pragma unroll 8
    for (int s = 0; s < n_act; ++s)
      a = fmaf(w[s], acc[(size_t)s * G * hd + d], a);
    repro::store(ob + d, a);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k_pages, *v_pages, *block_tables, *context_lens;
  float *ws_acc, *ws_ml;
  int B, H, KV, hd, page, n_pages, n_split, split_tokens;
  float qk_mul, cap_mul;  // see capped()
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t ring, size_t merge) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(ring > merge ? ring : merge));
}

template <int HD>
int launch_mma(const Args& a) {
  const int G = a.H / a.KV;
  const size_t ring = (size_t)kMmaStages * 2 * kMmaTile * (HD + 8) * 2 +
                      kMmaStages * kMmaTile * sizeof(long long);
  const size_t merge = ((size_t)4 * G * HD + 8 * G) * 4;
  const cudaError_t e = allow_smem(paged_split_mma_kernel<HD>, ring, merge);
  if (e != cudaSuccess) return (int)e;
  paged_split_mma_kernel<HD><<<dim3(a.KV, a.B, a.n_split), kThreads,
                               ring > merge ? ring : merge, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k_pages),
      static_cast<const bf16*>(a.v_pages),
      static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.context_lens), a.ws_acc, a.ws_ml, a.H, a.KV,
      a.page, a.n_pages, a.split_tokens, a.qk_mul, a.cap_mul);
  return (int)cudaGetLastError();
}

template <int G, int LANES>
int launch_fma(const Args& a) {
  using C = FmaCfg<LANES>;
  const size_t ring = (size_t)kFmaStages * 2 * C::kTile * a.hd * 4 +
                      kFmaStages * C::kTile * sizeof(long long);
  const size_t merge =
      ((size_t)C::kGroups * G * a.hd + 2 * C::kGroups * G) * 4;
  const cudaError_t e =
      allow_smem(paged_split_fma_kernel<G, LANES>, ring, merge);
  if (e != cudaSuccess) return (int)e;
  paged_split_fma_kernel<G, LANES><<<dim3(a.KV, a.B, a.n_split), kThreads,
                                     ring > merge ? ring : merge,
                                     a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_pages),
      static_cast<const float*>(a.v_pages),
      static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.context_lens), a.ws_acc, a.ws_ml, a.H, a.KV,
      a.hd, a.page, a.n_pages, a.split_tokens, a.qk_mul, a.cap_mul);
  return (int)cudaGetLastError();
}

template <int LANES>
int launch_fma_g(const Args& a) {
  switch (a.H / a.KV) {
    case 1: return launch_fma<1, LANES>(a);
    case 2: return launch_fma<2, LANES>(a);
    case 3: return launch_fma<3, LANES>(a);
    case 4: return launch_fma<4, LANES>(a);
    case 5: return launch_fma<5, LANES>(a);
    case 6: return launch_fma<6, LANES>(a);
    case 7: return launch_fma<7, LANES>(a);
    case 8: return launch_fma<8, LANES>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_pass1(const Args& a, bool is_bf16) {
  if (is_bf16) {
    switch (a.hd) {
      case 16: return launch_mma<16>(a);
      case 32: return launch_mma<32>(a);
      case 48: return launch_mma<48>(a);
      case 64: return launch_mma<64>(a);
      case 80: return launch_mma<80>(a);
      case 96: return launch_mma<96>(a);
      case 112: return launch_mma<112>(a);
      case 128: return launch_mma<128>(a);
      case 256: return launch_mma<256>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return a.hd <= 128 ? launch_fma_g<16>(a) : launch_fma_g<32>(a);
}

template <typename T>
int launch_merge(const Args& a, void* out) {
  paged_merge_kernel<T>
      <<<dim3(a.H, a.B), kThreads, 2 * a.n_split * sizeof(float), a.stream>>>(
          a.ws_acc, a.ws_ml, static_cast<const int*>(a.context_lens),
          static_cast<T*>(out), a.H, a.KV, a.hd, a.n_split, a.split_tokens,
          a.n_pages * a.page);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches both passes on `stream`.  workspace: B * H * n_split * (hd + 2)
// floats.  softcap <= 0 means no cap; scale <= 0 the scale 1/sqrt(hd).
// The splits must be whole 64-token
// tiles and cover the table:
// split_tokens % 64 == 0 and (n_split - 1) * split_tokens < n_pages * page
// <= n_split * split_tokens.  Returns cudaErrorInvalidValue for a split, a
// grouping (H / KV in 1..8) or a head dim (a multiple of 16 up to 128, or
// 256) that the kernel does not take, else cudaGetLastError() after the
// launches (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* context_lens, void* out,
                                      void* workspace, int B, int H, int KV,
                                      int hd, int page, int n_pages,
                                      int n_split, int split_tokens,
                                      float softcap, float scale,
                                      int is_bf16, void* stream) {
  const long long n_tokens = (long long)n_pages * page;
  if (n_split < 1 || split_tokens <= 0 || split_tokens % kSplitAlign ||
      (long long)(n_split - 1) * split_tokens >= n_tokens ||
      (long long)n_split * split_tokens < n_tokens || KV < 1 || H % KV ||
      H / KV > 8 || !((hd % 16 == 0 && hd >= 16 && hd <= 128) || hd == 256))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.block_tables = block_tables;
  a.context_lens = context_lens;
  a.ws_acc = static_cast<float*>(workspace);
  a.ws_ml = a.ws_acc + (size_t)B * H * n_split * hd;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.page = page;
  a.n_pages = n_pages;
  a.n_split = n_split;
  a.split_tokens = split_tokens;
  const bool cap = softcap > 0.f;
  if (scale > 0.f)
    a.qk_mul = cap ? scale / softcap : kLog2e * scale;
  else
    a.qk_mul = cap ? 1.0f / sqrtf((float)hd) / softcap
                   : kLog2e / sqrtf((float)hd);
  a.cap_mul = cap ? softcap * kLog2e : 0.f;
  a.stream = static_cast<cudaStream_t>(stream);
  const int e = launch_pass1(a, is_bf16 != 0);
  if (e != 0) return e;
  return is_bf16 ? launch_merge<bf16>(a, out) : launch_merge<float>(a, out);
}
