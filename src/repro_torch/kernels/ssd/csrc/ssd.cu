// Mamba-2 SSD chunked scan for Hopper (sm_90a): chunk-parallel passes.
//
// Replaces: src/repro/kernels/ssd/ssd.py, _ssd_kernel (:20) /
//   ssd_pallas (:69, pallas_call :85) (Pallas TPU kernel).
//
// Computes: for each (batch b, head h) of x [B, L, H, P], dt [B, L, H] f32,
//   A [H] f32 and B/C [B, L, G, N] (head h reads group h / (H / G)), walk
//   the sequence in chunks of Q rows.  Per chunk: seg = cumsum(dt * A);
//   y_i = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j (masked
//   before the exp) + exp(seg_i) C_i . state; then state = exp(seg_last)
//   state + sum_j exp(seg_last - seg_j) dt_j x_j B_j^T.  Emits y [B, L, H, P]
//   f32 and the final state [B, H, P, N] f32.  Everything is float32, as in
//   the Pallas kernel: no intermediate is rounded to the input type.
//
// Bound: for bf16 inputs on the tensor cores, device memory.  The scan
//   needs 2 N pairs flops per (batch, group, chunk) for C B^T, which the
//   H / G heads of a group share, plus 2 P pairs + 4 Q N P per (batch, head,
//   chunk) (pairs = Q (Q + 1) / 2 causal pairs): 6.5 GFLOP at B = 1,
//   L = 2048, H = 64, P = 64, N = 128, Q = 256, 0.0066 ms at 989 TFLOP/s,
//   against about 54 MB of x, B, C, dt, y and state moved once, 0.016 ms at
//   3.35 TB/s.  fp32 inputs run on FMAs, where the same flops take 0.097 ms
//   at 67 TFLOP/s: operations.
//
// Design (the state-space-duality decomposition, arXiv:2405.21060 §6-7).
//   The TPU walks the chunks as a sequential grid axis with the state in
//   VMEM.  Here three launches, each parallel over chunks, replace that
//   walk; the sequential part is a short recurrence over chunk states.
//   * Pass 1, one block per (chunk, group's C B^T tile or head, batch).  A
//     head's block computes seg of its chunk (summed in double, written to
//     ws_seg [B, H, L]) and the chunk's own state contribution s_c =
//     sum_j exp(seg_last - seg_j) dt_j x_j^T B_j, a [P, N] matrix written to
//     ws_st [B, nc, H, P, N].  The group blocks (the first rows of the grid,
//     scheduled first) compute C B^T of the chunk once for all H / G heads
//     of the group, one 64 x 64 tile at or left of the diagonal each, into
//     ws_cb [B, nc, G, Qp, Qp] (Qp = Q rounded up to 64; rows and columns
//     past Q hold zeros).
//   * Pass 2, four state elements per thread, runs S_0 = 0, S_c =
//     exp(seg_last,c) S_{c-1} + s_c over the chunks, writes each chunk's
//     starting state to ws_start [B, nc, H, P, N] (for bf16 inputs as its
//     bf16 hi and lo parts, the operand pass 3 feeds to the tensor cores)
//     and the last to `state`.
//   * Pass 3, one block per (64-row query tile, chunk, head, batch), the
//     heaviest tiles (most key tiles) first: y_i = exp(seg_i) C_i S_start^T
//     + sum over key tiles at or left of the diagonal of att . x_j, att =
//     CB * exp(seg_i - seg_j) dt_j masked before the exp.  y is written
//     once.  The first chunk starts from zero and skips the first term.
//   bf16 inputs run every product on the tensor cores (mma.sync.m16n8k16,
//   operands from shared memory by ldmatrix, rows padded by 16 bytes so
//   that ldmatrix is conflict-free).  C B^T and C S^T's C are bf16 already.
//   The other operand of three products is an fp32 intermediate: att, the
//   starting state and the weighted x.  Each is split into hi = bf16(v) and
//   lo = bf16(v - hi), and the product is taken twice into one fp32
//   accumulator, which keeps about 16 bits of the operand.  In pass 3, att
//   is built in registers as A fragments (its exp by ex2.approx), from C
//   B^T values that each lane loads from L2 a key tile ahead; x rows stream
//   through a two-stage cp.async ring.  At about 73 KB of shared memory,
//   three pass-3 blocks fit on an SM.  Pass 1's head blocks load the next
//   key tile's B rows (cp.async) and x rows (registers) while this tile's
//   products run.
//   fp32 inputs take the same passes with their products on FMAs (64 x 64
//   tiles, 4 x 4 outputs per thread over shared rows padded to a stride of
//   1 mod 32 words): the tensor cores would round them to TF32.

#include <stdint.h>

#include <type_traits>

#include "vec.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;            // chunk rows per tile; also the max P
constexpr int kMaxN = 128;
constexpr int kThreads = 256;        // passes 1 and 2, fp32 pass 3
constexpr int kScanThreads = 128;    // bf16 pass 3: a warp per 16 query rows
constexpr int kStages = 2;           // bf16 pass 3 key-tile ring
// fp32 rows, padded to a stride of 1 mod 32 words
constexpr int kLdN = kMaxN + 1;
constexpr int kLdT = kTile + 1;
// bf16 rows padded by 16 bytes (ldmatrix without conflicts)
constexpr int kLdNh = kMaxN + 8;
constexpr int kLdTh = kTile + 8;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
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

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x, approximate; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += A B for one m16n8k16 bf16 product, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (hi + lo) B: the fp32 operand split into two bf16 parts, lo first.
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint32_t b0,
                                     uint32_t b1) {
  mma(d, lo, b0, b1);
  mma(d, hi, b0, b1);
}

// hi = bf16(a, b), lo = bf16(a - hi.x, b - hi.y), packed as bf16 pairs (the
// lower column in the low half).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ldmatrix row addresses of lane l for one 16 x 16 operand tile (x4), as
// (row, column) offsets of the tile as it is stored:
//   A stored [m][k]:            a_frag_rowmajor
//   A stored [k][m], .trans:    a_frag_trans
//   B stored [n][k]:            b_frag_nk   (registers 0,1: n 0-7; 2,3: n 8-15)
//   B stored [k][n], .trans:    b_frag_kn   (the same)
__device__ __forceinline__ int2 a_frag_rowmajor(int l) {
  return make_int2(l & 15, (l >> 4) * 8);
}
__device__ __forceinline__ int2 a_frag_trans(int l) {
  return make_int2((l >> 4) * 8 + (l & 7), ((l >> 3) & 1) * 8);
}
__device__ __forceinline__ int2 b_frag_nk(int l) {
  return make_int2((l >> 4) * 8 + (l & 7), ((l >> 3) & 1) * 8);
}
__device__ __forceinline__ int2 b_frag_kn(int l) {
  return make_int2(((l >> 3) & 1) * 8 + (l & 7), (l >> 4) * 8);
}

// ---------------------------------------------------------------------------
// fp32 helpers (FMA products)
// ---------------------------------------------------------------------------

// acc[r][c] += sum_k a[(ty + 16 r) * LDA + k] * b[(tx + 16 c) * LDB + k]:
// a 64 x 64 block of A B^T, 4 x 4 outputs per thread.
template <int LDA, int LDB>
__device__ __forceinline__ void mma_abt(float (&acc)[4][4], const float* a,
                                        const float* b, int K, int ty,
                                        int tx) {
  const float* a0 = a + ty * LDA;
  const float* b0 = b + tx * LDB;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a0[16 * r * LDA + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b0[16 * c * LDB + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// Stage `rows` rows of `width` elements (row r at src + r * stride) into
// shared memory as floats: dst[r * ld + w], or dst[w * ld + r] when
// kTranspose.  Each row is scaled by scale[r] when scale is not null.  Rows
// from `rows` to kTile are zeros when not kTranspose.  16-byte loads: width
// and stride are multiples of 16 bytes and src is 16-byte aligned (the
// wrapper checks).
template <typename T, bool kTranspose>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           long long stride, int rows,
                                           int width, const float* scale) {
  constexpr int vec = 16 / (int)sizeof(T);
  const int per_row = width / vec;
  const int n_rows = kTranspose ? rows : kTile;
  for (int i = threadIdx.x; i < n_rows * per_row; i += kThreads) {
    const int r = i / per_row, v = i - r * per_row;
    float f[vec];
    if (r < rows) {
      repro::load16(src + r * stride + v * vec, f);
    } else {
#pragma unroll
      for (int e = 0; e < vec; ++e) f[e] = 0.f;
    }
    const float s = scale && r < rows ? scale[r] : 1.f;
#pragma unroll
    for (int e = 0; e < vec; ++e) {
      if (kTranspose)
        dst[(v * vec + e) * ld + r] = f[e] * s;
      else
        dst[r * ld + v * vec + e] = f[e] * s;
    }
  }
}

// ---------------------------------------------------------------------------
// The shapes every pass reads
// ---------------------------------------------------------------------------

struct Dims {
  int L, H, G, P, N, Q;
  int nc;  // chunks, L / Q
  int nq;  // 64-row tiles of a chunk
  int Qp;  // nq * 64: the row stride of a chunk's C B^T
  __device__ __forceinline__ long long xrow() const { return (long long)H * P; }
  __device__ __forceinline__ long long bcrow() const {
    return (long long)G * N;
  }
};

// seg[q] = inclusive cumsum of dt[q] * a_h over the chunk's Q rows (warp 0,
// summed in double and rounded once), with sdt[q] = dt[q]; dtb points at the
// chunk's first dt of this head.
__device__ void chunk_cumsum(const float* dtb, int H, float a_h, int Q,
                             float* sdt, float* seg) {
  const int tid = threadIdx.x;
  for (int q = tid; q < Q; q += blockDim.x) sdt[q] = dtb[(long long)q * H];
  __syncthreads();
  if (tid < 32) {
    const int per = (Q + 31) / 32, q0 = tid * per;
    double run = 0.0;
    for (int k = 0; k < per && q0 + k < Q; ++k)
      run += (double)(sdt[q0 + k] * a_h);
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += v;
    }
    double acc = incl - run;
    for (int k = 0; k < per && q0 + k < Q; ++k) {
      acc += (double)(sdt[q0 + k] * a_h);
      seg[q0 + k] = (float)acc;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Pass 1, group blocks: one 64 x 64 tile (it, jt), jt <= it, of a chunk's
// C B^T
// ---------------------------------------------------------------------------

// bf16: 8 warps, each 16 rows x 32 columns of the tile.
__device__ void chunk_cb_mma(const bf16* Cb, const bf16* Bb, float* cb,
                             int it, int jt, const Dims& d,
                             unsigned char* smem) {
  bf16* sC = reinterpret_cast<bf16*>(smem);  // [kTile][kLdNh] C rows
  bf16* sB = sC + kTile * kLdNh;             // [kTile][kLdNh] B rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = warp & 3, nh = warp >> 2;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const long long bcrow = d.bcrow();
  const int2 fa = a_frag_rowmajor(lane), fb = b_frag_nk(lane);
  // rows r0.. of src into dst: 64 rows of 128, zeros past Q and N
  auto stage = [&](bf16* dst, const bf16* src, int r0) {
    for (int i = tid; i < kTile * (kMaxN / 8); i += kThreads) {
      const int r = i >> 4, ch = i & 15;
      const bool ok = r0 + r < d.Q && ch * 8 < d.N;
      cp_async16(dst + r * kLdNh + ch * 8,
                 ok ? src + (long long)(r0 + r) * bcrow + ch * 8 : src,
                 ok ? 16 : 0);
    }
  };
  stage(sC, Cb, it * kTile);
  stage(sB, Bb, jt * kTile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < kMaxN / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, sC + (mt * 16 + fa.x) * kLdNh + ks * 16 + fa.y);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, sB + (nh * 32 + np * 16 + fb.x) * kLdNh + ks * 16 + fb.y);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
  float* out = cb + (long long)(it * kTile + mt * 16 + g) * d.Qp +
               jt * kTile + nh * 32 + c2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(out + nt * 8) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + 8 * (long long)d.Qp + nt * 8) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// fp32: 16 x 16 threads, 4 x 4 outputs each.
__device__ void chunk_cb_fma(const float* Cb, const float* Bb, float* cb,
                             int it, int jt, const Dims& d,
                             unsigned char* smem) {
  float* sC = reinterpret_cast<float*>(smem);  // [kTile][kLdN]
  float* sB = sC + kTile * kLdN;               // [kTile][kLdN]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bcrow = d.bcrow();
  const int i0 = it * kTile, j0 = jt * kTile;
  stage_rows<float, false>(sC, kLdN, Cb + (long long)i0 * bcrow, bcrow,
                           min(kTile, d.Q - i0), d.N, nullptr);
  stage_rows<float, false>(sB, kLdN, Bb + (long long)j0 * bcrow, bcrow,
                           min(kTile, d.Q - j0), d.N, nullptr);
  __syncthreads();
  float acc[4][4] = {};
  mma_abt<kLdN, kLdN>(acc, sC, sB, d.N, ty, tx);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      cb[(long long)(i0 + ty + 16 * r) * d.Qp + j0 + tx + 16 * c] =
          acc[r][c];
}

// ---------------------------------------------------------------------------
// Pass 1, head blocks: seg and the chunk's own state contribution
// ---------------------------------------------------------------------------

// bf16: s_c[p][n] = sum_j (w_j x_j[p]) B_j[n], w x split into hi and lo;
// 8 warps, each 16 rows of p x 64 columns of n.  The next key tile's B rows
// (cp.async, two stages) and x rows (registers) load while this tile's
// products run.
__device__ void chunk_state_mma(const bf16* xb, const bf16* Bb,
                                const float* w, float* st, const Dims& d,
                                unsigned char* smem) {
  bf16* sB = reinterpret_cast<bf16*>(smem);  // [2][kTile][kLdNh] B [j][n]
  bf16* sXh = sB + 2 * kTile * kLdNh;        // [kTile][kLdTh]  hi(w x) [j][p]
  bf16* sXl = sXh + kTile * kLdTh;           // [kTile][kLdTh]  lo(w x)
  constexpr int kXLoads = kTile * (kTile / 8) / kThreads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mt = warp & 3, nh = warp >> 2;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const long long xrow = d.xrow(), bcrow = d.bcrow();
  const int2 fa = a_frag_trans(lane), fb = b_frag_kn(lane);
  auto load_b = [&](int j0, bf16* dst) {
    for (int i = tid; i < kTile * (kMaxN / 8); i += kThreads) {
      const int r = i >> 4, ch = i & 15;
      const bool ok = j0 + r < d.Q && ch * 8 < d.N;
      cp_async16(dst + r * kLdNh + ch * 8,
                 ok ? Bb + (long long)(j0 + r) * bcrow + ch * 8 : Bb,
                 ok ? 16 : 0);
    }
  };
  auto load_x = [&](int j0, uint4 (&xr)[kXLoads]) {
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
      const int i = tid + k * kThreads, r = i >> 3, ch = i & 7;
      xr[k] = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < d.Q && ch * 8 < d.P)
        xr[k] = *reinterpret_cast<const uint4*>(
            xb + (long long)(j0 + r) * xrow + ch * 8);
    }
  };
  float acc[8][4] = {};
  uint4 xr[kXLoads];
  load_b(0, sB);
  cp_async_commit();
  load_x(0, xr);
  for (int t = 0, j0 = 0; j0 < d.Q; ++t, j0 += kTile) {
    __syncthreads();  // the last tile's readers of sXh, sXl and sB are done
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
      const int i = tid + k * kThreads, r = i >> 3, ch = i & 7;
      float f[8];
      repro::widen16(xr[k], f, bf16());
      const float s = j0 + r < d.Q ? w[j0 + r] : 0.f;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split2(f[2 * e] * s, f[2 * e + 1] * s, hi[e], lo[e]);
      *reinterpret_cast<uint4*>(sXh + r * kLdTh + ch * 8) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sXl + r * kLdTh + ch * 8) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (j0 + kTile < d.Q) {
      load_b(j0 + kTile, sB + ((t + 1) & 1) * kTile * kLdNh);
      load_x(j0 + kTile, xr);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's B rows landed
    __syncthreads();
    const bf16* sb = sB + (t & 1) * kTile * kLdNh;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t ah[4], al[4];
      const int ao = (ks * 16 + fa.x) * kLdTh + mt * 16 + fa.y;
      ldsm_x4_trans(ah, sXh + ao);
      ldsm_x4_trans(al, sXl + ao);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, sb + (ks * 16 + fb.x) * kLdNh + nh * 64 + np * 16 +
                             fb.y);
        mma2(acc[2 * np], ah, al, b[0], b[1]);
        mma2(acc[2 * np + 1], ah, al, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = mt * 16 + g + 8 * half;
    if (p >= d.P) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nh * 64 + nt * 8 + c2;
      if (n < d.N)
        *reinterpret_cast<float2*>(st + (long long)p * d.N + n) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// fp32: 16 x 16 threads, 4 x 8 outputs each.
__device__ void chunk_state_fma(const float* xb, const float* Bb,
                                const float* w, float* st, const Dims& d,
                                unsigned char* smem) {
  float* sB = reinterpret_cast<float*>(smem);  // [kTile][kLdN]  B rows [j][n]
  float* sX = sB + kTile * kLdN;               // [kTile][kLdT]  (w x)^T [p][j]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long xrow = d.xrow(), bcrow = d.bcrow();
  float sacc[4][8] = {};
  for (int j0 = 0; j0 < d.Q; j0 += kTile) {
    const int nj = min(kTile, d.Q - j0);
    __syncthreads();  // the last tile's readers are done
    stage_rows<float, false>(sB, kLdN, Bb + (long long)j0 * bcrow, bcrow, nj,
                             d.N, nullptr);
    stage_rows<float, true>(sX, kLdT, xb + (long long)j0 * xrow, xrow, nj,
                            d.P, w + j0);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      float av[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = sX[(ty + 16 * r) * kLdT + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = sB[j * kLdN + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) sacc[r][c] = fmaf(av[r], bv[c], sacc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = tx + 16 * c;
      if (p < d.P && n < d.N) st[(long long)p * d.N + n] = sacc[r][c];
    }
  }
}

// Grid (nc, G * pairs + H, B), pairs = nq (nq + 1) / 2: rows y < G * pairs
// are the groups' C B^T tiles (scheduled first), the rest the heads'
// chunk-state blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ ws_seg,
                 float* __restrict__ ws_st, float* __restrict__ ws_cb, Dims d,
                 int tile_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, b = blockIdx.z;
  const long long row0 = (long long)b * d.L + (long long)c * d.Q;
  const int pairs = d.nq * (d.nq + 1) / 2;
  if ((int)blockIdx.y < d.G * pairs) {
    const int g = blockIdx.y / pairs, pair = blockIdx.y - g * pairs;
    int it = 0;
    while ((it + 1) * (it + 2) / 2 <= pair) ++it;
    const int jt = pair - it * (it + 1) / 2;
    const T* Cb = Cm + row0 * d.bcrow() + (long long)g * d.N;
    const T* Bb = Bm + row0 * d.bcrow() + (long long)g * d.N;
    float* cb = ws_cb + (((long long)b * d.nc + c) * d.G + g) * d.Qp * d.Qp;
    if constexpr (std::is_same<T, bf16>::value)
      chunk_cb_mma(Cb, Bb, cb, it, jt, d, smem);
    else
      chunk_cb_fma(Cb, Bb, cb, it, jt, d, smem);
    return;
  }
  const int h = blockIdx.y - d.G * pairs, g = h / (d.H / d.G);
  float* sdt = reinterpret_cast<float*>(smem + tile_bytes);  // [Q]
  float* seg = sdt + d.Q;                                     // [Q]
  chunk_cumsum(dt + row0 * d.H + h, d.H, A[h], d.Q, sdt, seg);
  float* segw = ws_seg + ((long long)b * d.H + h) * d.L + (long long)c * d.Q;
  const float seg_last = seg[d.Q - 1];
  for (int q = threadIdx.x; q < d.Q; q += kThreads) {
    segw[q] = seg[q];
    sdt[q] = expf(seg_last - seg[q]) * sdt[q];  // the state weights w
  }
  __syncthreads();
  const T* xb = x + row0 * d.xrow() + (long long)h * d.P;
  const T* Bb = Bm + row0 * d.bcrow() + (long long)g * d.N;
  float* st =
      ws_st + (((long long)b * d.nc + c) * d.H + h) * (long long)d.P * d.N;
  if constexpr (std::is_same<T, bf16>::value)
    chunk_state_mma(xb, Bb, sdt, st, d, smem);
  else
    chunk_state_fma(xb, Bb, sdt, st, d, smem);
}

// ---------------------------------------------------------------------------
// Pass 2: the recurrence over chunk states
// ---------------------------------------------------------------------------

// Grid (ceil(P N / 1024), H, B): four state elements per thread.  Reads
// s_c from ws_st; writes the state at the start of chunk c to slot c of
// ws_start, as fp32 [P][N] or (kSplit) as bf16 hi [P][N] then lo [P][N],
// the operand pass 3 feeds to the tensor cores.  The loads of eight chunks
// are issued before their recurrence steps.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(const float* __restrict__ ws_st,
                      const float* __restrict__ ws_seg,
                      float* __restrict__ ws_start, float* __restrict__ state,
                      Dims d) {
  constexpr int kBatch = 8;
  const int PN = d.P * d.N;  // a multiple of 64
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (4 * e >= PN) return;
  const float* seg_last =
      ws_seg + ((long long)b * d.H + h) * d.L + (d.Q - 1);
  const long long slot0 = ((long long)b * d.nc * d.H + h) * PN;
  const long long step = (long long)d.H * PN;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < d.nc; c0 += kBatch) {
    float4 own[kBatch];
    float decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < d.nc) {
        own[k] = reinterpret_cast<const float4*>(
            ws_st + slot0 + (c0 + k) * step)[e];
        decay[k] = expf(seg_last[(long long)(c0 + k) * d.Q]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < d.nc) {
        float* out = ws_start + slot0 + (c0 + k) * step;
        if (kSplit) {
          uint2 hi, lo;
          split2(S.x, S.y, hi.x, lo.x);
          split2(S.z, S.w, hi.y, lo.y);
          bf16* o = reinterpret_cast<bf16*>(out);
          reinterpret_cast<uint2*>(o)[e] = hi;
          reinterpret_cast<uint2*>(o + PN)[e] = lo;
        } else {
          reinterpret_cast<float4*>(out)[e] = S;
        }
        S.x = decay[k] * S.x + own[k].x;
        S.y = decay[k] * S.y + own[k].y;
        S.z = decay[k] * S.z + own[k].z;
        S.w = decay[k] * S.w + own[k].w;
      }
    }
  }
  reinterpret_cast<float4*>(state + ((long long)b * d.H + h) * PN)[e] = S;
}

// ---------------------------------------------------------------------------
// Pass 3: the chunk scan
// ---------------------------------------------------------------------------

// The tile a pass-3 block owns and the pointers it reads.
template <typename T>
struct ScanTile {
  int c, h, b, g, iq, i0, ni;
  const T* xb;           // x rows of chunk c, head h
  const T* Cb;           // C rows of chunk c, group g
  const float* segb;     // ws_seg of chunk c, head h
  const float* dtb;      // dt of chunk c, head h (stride H)
  const float* st;       // ws_start: the starting state (pass 2's layout)
  const float* cb;       // ws_cb: the chunk's C B^T [Qp][Qp]
  float* yb;             // y rows of chunk c, head h

  __device__ ScanTile(const T* x, const float* dt, const T* Cm,
                      const float* ws_seg, const float* ws_start,
                      const float* ws_cb, float* y, const Dims& d) {
    c = blockIdx.x / d.H;
    h = blockIdx.x - c * d.H;
    iq = d.nq - 1 - blockIdx.y;  // the heaviest tiles first
    b = blockIdx.z;
    g = h / (d.H / d.G);
    i0 = iq * kTile;
    ni = min(kTile, d.Q - i0);
    const long long row0 = (long long)b * d.L + (long long)c * d.Q;
    xb = x + row0 * d.xrow() + (long long)h * d.P;
    Cb = Cm + row0 * d.bcrow() + (long long)g * d.N;
    segb = ws_seg + ((long long)b * d.H + h) * d.L + (long long)c * d.Q;
    dtb = dt + row0 * d.H + h;
    st = ws_start + (((long long)b * d.nc + c) * d.H + h) * (long long)d.P *
                        d.N;
    cb = ws_cb + (((long long)b * d.nc + c) * d.G + g) * d.Qp * d.Qp;
    yb = y + row0 * d.xrow() + (long long)h * d.P;
  }
};

// bf16: 4 warps, each 16 query rows x all P columns.  The query tile's C
// rows and the starting state's hi and lo parts (pass 2 wrote them as bf16)
// arrive by cp.async, then the key tiles' x rows through a kStages ring; the
// lane's C B^T values of the next key tile load into registers while this
// one's products run.
__global__ void __launch_bounds__(kScanThreads, 3)
ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const bf16* __restrict__ Cm,
                    const float* __restrict__ ws_seg,
                    const float* __restrict__ ws_start,
                    const float* __restrict__ ws_cb, float* __restrict__ y,
                    Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanTile<bf16> t(x, dt, Cm, ws_seg, ws_start, ws_cb, y, d);
  bf16* sC = reinterpret_cast<bf16*>(smem);  // [kTile][kLdNh]  C rows [i][n]
  bf16* sSh = sC + kTile * kLdNh;            // [kTile][kLdNh]  hi(S) [p][n]
  bf16* sSl = sSh + kTile * kLdNh;           // [kTile][kLdNh]  lo(S)
  bf16* ring_x = sSl + kTile * kLdNh;        // [kStages][kTile][kLdTh] x [j][p]
  // seg and dt of the chunk's rows 0 .. i0 + ni - 1
  float* sSeg = reinterpret_cast<float*>(ring_x + kStages * kTile * kLdTh);
  float* sDt = sSeg + d.Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const long long xrow = d.xrow(), bcrow = d.bcrow();
  const bool has_state = t.c > 0;  // the first chunk starts from zero

  auto issue = [&](int jt) {  // x rows of key tile jt into stage jt % kStages
    bf16* sx = ring_x + (jt % kStages) * kTile * kLdTh;
    const int j0 = jt * kTile;
    for (int i = tid; i < kTile * (kTile / 8); i += kScanThreads) {
      const int r = i >> 3, ch = i & 7;
      const bool ok = j0 + r < d.Q && ch * 8 < d.P;
      cp_async16(sx + r * kLdTh + ch * 8,
                 ok ? t.xb + (long long)(j0 + r) * xrow + ch * 8 : t.xb,
                 ok ? 16 : 0);
    }
  };

  // group 0: C rows and the starting state, which only the inter-chunk term
  // reads; zeros past ni, P and N.  Groups 1 .. kStages - 1: key tiles.
  if (has_state) {
    const bf16* sh = reinterpret_cast<const bf16*>(t.st);
    const bf16* sl = sh + d.P * d.N;
    for (int i = tid; i < kTile * (kMaxN / 8); i += kScanThreads) {
      const int r = i >> 4, ch = i & 15;
      const bool n_ok = ch * 8 < d.N;
      const bool c_ok = r < t.ni && n_ok, s_ok = r < d.P && n_ok;
      const int o = r * kLdNh + ch * 8;
      cp_async16(sC + o,
                 c_ok ? t.Cb + (long long)(t.i0 + r) * bcrow + ch * 8 : t.Cb,
                 c_ok ? 16 : 0);
      cp_async16(sSh + o, s_ok ? sh + r * d.N + ch * 8 : sh, s_ok ? 16 : 0);
      cp_async16(sSl + o, s_ok ? sl + r * d.N + ch * 8 : sl, s_ok ? 16 : 0);
    }
  }
  cp_async_commit();
  for (int jt = 0; jt < kStages - 1; ++jt) {
    if (jt <= t.iq) issue(jt);
    cp_async_commit();
  }
  for (int q = tid; q < t.i0 + t.ni; q += kScanThreads) {
    sSeg[q] = t.segb[q];
    sDt[q] = t.dtb[(long long)q * d.H];
  }
  cp_async_wait<kStages - 1>();  // group 0 landed
  __syncthreads();

  // inter-chunk: acc = exp(seg_i) (C_i . S^T), rows warp * 16 + (g, g + 8)
  float acc[8][4] = {};
  if (has_state) {
    const int2 fa = a_frag_rowmajor(lane), fb = b_frag_nk(lane);
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sC + (warp * 16 + fa.x) * kLdNh + ks * 16 + fa.y);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bh[4], bl[4];
        const int bo = (np * 16 + fb.x) * kLdNh + ks * 16 + fb.y;
        ldsm_x4(bh, sSh + bo);
        ldsm_x4(bl, sSl + bo);
        mma(acc[2 * np], a, bl[0], bl[1]);
        mma(acc[2 * np], a, bh[0], bh[1]);
        mma(acc[2 * np + 1], a, bl[2], bl[3]);
        mma(acc[2 * np + 1], a, bh[2], bh[3]);
      }
    }
  }
  const int ri = warp * 16 + g;  // this lane's first row within the tile
  const int qi0 = t.i0 + ri, qi1 = qi0 + 8;
  const float seg0 = qi0 < d.Q ? sSeg[qi0] : 0.f;
  const float seg1 = qi1 < d.Q ? sSeg[qi1] : 0.f;
  {
    const float e0 = qi0 < d.Q ? expf(seg0) : 0.f;
    const float e1 = qi1 < d.Q ? expf(seg1) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
  }

  // intra-chunk: key tiles at or left of the diagonal.  This lane's C B^T
  // values of a key tile, in A-fragment order (a0..a3: rows ri, ri + 8 x
  // columns kc, kc + 8), load into registers a tile ahead, from L2.
  auto load_cb = [&](int jt, float2 (&r)[kTile / 16][4]) {
    const float* src = t.cb + (long long)(t.i0 + ri) * d.Qp + jt * kTile + c2;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        r[ks][f] = *reinterpret_cast<const float2*>(
            src + (f & 1) * 8 * (long long)d.Qp + ks * 16 + (f >> 1) * 8);
  };
  const int2 fb = b_frag_kn(lane);
  float2 cur[kTile / 16][4], nxt[kTile / 16][4];
  load_cb(0, cur);
  for (int jt = 0; jt <= t.iq; ++jt) {
    if (jt < t.iq) load_cb(jt + 1, nxt);
    cp_async_wait<kStages - 2>();  // this thread's copies of tile jt landed
    __syncthreads();  // everyone's, and tile jt - 1's stage is free
    if (jt + kStages - 1 <= t.iq) issue(jt + kStages - 1);
    cp_async_commit();
    const bf16* sx = ring_x + (jt % kStages) * kTile * kLdTh;
    // on the diagonal, warp w's rows need key steps 0..w only
    const int ks_end = jt == t.iq ? warp + 1 : kTile / 16;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      if (ks >= ks_end) continue;
      // att fragments: rows (qi0, qi1) x key columns (kc, kc + 1) and
      // (kc + 8, kc + 9); masked before the exp
      const int kc = ks * 16 + c2, qj = jt * kTile + kc;
      float v[8];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = f & 1, col = (f >> 1) * 8;  // a0..a3 order
        const int qi = row ? qi1 : qi0;
        const float si = row ? seg1 : seg0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = qj + col + e;
          const float cbv = e ? cur[ks][f].y : cur[ks][f].x;
          v[2 * f + e] = (j <= qi && qi < d.Q)
                             ? cbv * ex2((si - sSeg[j]) * kLog2e) * sDt[j]
                             : 0.f;
        }
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) split2(v[2 * f], v[2 * f + 1], ah[f], al[f]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, sx + (ks * 16 + fb.x) * kLdTh + np * 16 + fb.y);
        mma2(acc[2 * np], ah, al, b[0], b[1]);
        mma2(acc[2 * np + 1], ah, al, b[2], b[3]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks)
#pragma unroll
      for (int f = 0; f < 4; ++f) cur[ks][f] = nxt[ks][f];
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qi1 : qi0;
    if (qi >= d.Q) continue;
    float* yr = t.yb + (long long)qi * xrow;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = nt * 8 + c2;
      if (p < d.P)
        *reinterpret_cast<float2*>(yr + p) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// fp32: 16 x 16 threads, 4 x 4 outputs each.
__global__ void __launch_bounds__(kThreads)
ssd_scan_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Cm,
                    const float* __restrict__ ws_seg,
                    const float* __restrict__ ws_start,
                    const float* __restrict__ ws_cb, float* __restrict__ y,
                    Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanTile<float> t(x, dt, Cm, ws_seg, ws_start, ws_cb, y, d);
  float* sC = reinterpret_cast<float*>(smem);  // [kTile][kLdN]  C rows [i][n]
  float* sS = sC + kTile * kLdN;               // [kTile][kLdN]  S [p][n]
  float* sX = sS + kTile * kLdN;               // [kTile][kLdT]  x^T [p][j]
  float* sAtt = sX + kTile * kLdT;             // [kTile][kLdT]  att [i][j]
  float* sSeg = sAtt + kTile * kLdT;           // [i0 + ni]
  float* sDt = sSeg + d.Q;                     // [i0 + ni]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long xrow = d.xrow(), bcrow = d.bcrow();

  stage_rows<float, false>(sC, kLdN, t.Cb + (long long)t.i0 * bcrow, bcrow,
                           t.ni, d.N, nullptr);
  stage_rows<float, false>(sS, kLdN, t.st, d.N, d.P, d.N, nullptr);
  for (int q = tid; q < t.i0 + t.ni; q += kThreads) {
    sSeg[q] = t.segb[q];
    sDt[q] = t.dtb[(long long)q * d.H];
  }
  __syncthreads();
  // inter-chunk: y_i = exp(seg_i) * (C_i . S^T)
  float acc[4][4] = {};
  mma_abt<kLdN, kLdN>(acc, sC, sS, d.N, ty, tx);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    const float e = i < t.ni ? expf(sSeg[t.i0 + i]) : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] *= e;
  }
  for (int jt = 0; jt <= t.iq; ++jt) {
    const int j0 = jt * kTile, nj = min(kTile, d.Q - j0);
    __syncthreads();  // the last key tile's readers are done
    stage_rows<float, true>(sX, kLdT, t.xb + (long long)j0 * xrow, xrow, nj,
                            d.P, nullptr);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r, qi = t.i0 + i;
      const float* cbr = t.cb + (long long)qi * d.Qp + j0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c, qj = j0 + j;
        sAtt[i * kLdT + j] =  // masked before the exp: no overflow above
            (qj <= qi && i < t.ni)
                ? cbr[j] * expf(sSeg[qi] - sSeg[qj]) * sDt[qj]
                : 0.f;
      }
    }
    __syncthreads();
    mma_abt<kLdT, kLdT>(acc, sAtt, sX, nj, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= t.ni) continue;
    float* yr = t.yb + (long long)(t.i0 + i) * xrow;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx + 16 * c;
      if (p < d.P) yr[p] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, void* ws_seg, void* ws_st,
           void* ws_start, void* ws_cb, int Bsz, const Dims& d,
           cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  // pass 1: the tiles of the larger role, then sdt and seg
  const int tile_bytes =
      kBf16 ? (int)(2 * (kTile * kLdNh + kTile * kLdTh) * sizeof(bf16))
            : (int)(2 * kTile * kLdN * sizeof(float));
  const size_t smem1 = tile_bytes + 2 * (size_t)d.Q * sizeof(float);
  const size_t smem3 =
      (kBf16 ? (3 * kTile * kLdNh + kStages * kTile * kLdTh) * sizeof(bf16)
             : (2 * kTile * kLdN + 2 * kTile * kLdT) * sizeof(float)) +
      2 * (size_t)d.Q * sizeof(float);
  cudaError_t e = allow_smem(ssd_chunk_kernel<T>, smem1);
  if (e != cudaSuccess) return (int)e;
  const int pairs = d.nq * (d.nq + 1) / 2;
  ssd_chunk_kernel<T><<<dim3(d.nc, d.G * pairs + d.H, Bsz), kThreads, smem1,
                        stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(ws_seg),
      static_cast<float*>(ws_st), static_cast<float*>(ws_cb), d, tile_bytes);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_state_pass_kernel<kBf16>
      <<<dim3((d.P * d.N / 4 + kThreads - 1) / kThreads, d.H, Bsz), kThreads,
          0, stream>>>(static_cast<const float*>(ws_st),
                       static_cast<const float*>(ws_seg),
                       static_cast<float*>(ws_start),
                       static_cast<float*>(state), d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 grid3(d.nc * d.H, d.nq, Bsz);
  if constexpr (kBf16) {
    if ((e = allow_smem(ssd_scan_mma_kernel, smem3)) != cudaSuccess)
      return (int)e;
    ssd_scan_mma_kernel<<<grid3, kScanThreads, smem3, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt),
        static_cast<const bf16*>(Cm), static_cast<const float*>(ws_seg),
        static_cast<const float*>(ws_start), static_cast<const float*>(ws_cb),
        static_cast<float*>(y), d);
  } else {
    if ((e = allow_smem(ssd_scan_fma_kernel, smem3)) != cudaSuccess)
      return (int)e;
    ssd_scan_fma_kernel<<<grid3, kThreads, smem3, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(Cm), static_cast<const float*>(ws_seg),
        static_cast<const float*>(ws_start), static_cast<const float*>(ws_cb),
        static_cast<float*>(y), d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the first CUDA error of the three launches (0 on success).  The
// wrapper guarantees L % Q == 0, H % G == 0, P <= 64 and N <= 128, both
// multiples of 8, contiguous 16-byte aligned inputs, and fp32 workspaces of
// ws_seg [B, H, L], ws_st and ws_start [B, L / Q, H, P, N] each, and ws_cb
// [B, L / Q, G, Qp, Qp], Qp = Q rounded up to a multiple of 64.  A chunk
// too long for one block's shared memory is refused by cudaFuncSetAttribute.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, void* y, void* state,
                          void* ws_seg, void* ws_st, void* ws_start,
                          void* ws_cb, int Bsz, int L, int H, int G, int P,
                          int N, int Q, int is_bf16, void* stream) {
  Dims d;
  d.L = L, d.H = H, d.G = G, d.P = P, d.N = N, d.Q = Q;
  d.nc = L / Q;
  d.nq = (Q + kTile - 1) / kTile;
  d.Qp = d.nq * kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(x, dt, A, Bm, Cm, y, state, ws_seg, ws_st, ws_start,
                        ws_cb, Bsz, d, s);
  return launch<float>(x, dt, A, Bm, Cm, y, state, ws_seg, ws_st, ws_start,
                       ws_cb, Bsz, d, s);
}
