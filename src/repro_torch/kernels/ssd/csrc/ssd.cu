// Mamba-2 SSD chunked scan for Hopper (sm_90a).
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
//   the Pallas kernel; bf16 inputs are widened on load.
//
// Bound: operations.  The scan needs 2 N pairs flops per (batch, group,
//   chunk) for C B^T, which the H / G heads of a group share, plus
//   2 P pairs + 4 Q N P per (batch, head, chunk) (pairs = Q (Q + 1) / 2
//   causal pairs); each head moves Q P elements of x in and Q P floats of
//   y out.  At Q = 256, P = 64, N = 128 that is ~13 MFLOP per head against
//   ~130 KB, about 100 flops per byte, far above the ~20 flops per byte at
//   which Hopper's fp32 units (67 TFLOP/s), not its memory (3.35 TB/s), are
//   the limit.  This version computes C B^T in every head (see below).
//
// Design (first version: right and simple, plain FMAs): one block per
//   (head, batch).  The TPU walks the chunks as a sequential grid axis with
//   the state in VMEM scratch; here a loop over chunks runs inside the block
//   and the [P, N] f32 state (64 x 128, 32 KB) stays in shared memory for
//   the whole sequence.  A whole 256-row chunk in f32 (x 64 KB, B and C
//   128 KB each) does not fit in 227 KB of shared memory, so each chunk is
//   cut into 64-row tiles: for each tile of query rows i, C_i is staged and
//   the inter-chunk output C_i . state^T is taken first; then for each tile
//   of key rows j <= i, B_j and x_j^T are staged, (C_i B_j^T) is masked and
//   weighted into a 64 x 64 att tile and att . x_j accumulates in
//   registers.  A last pass over the key tiles updates the state.  Every
//   product is a 64 x 64 output over 256 threads, 4 x 4 per thread, read
//   from shared rows padded to a stride of 1 mod 32 words, so neither
//   operand's reads conflict on banks.  Left for later work (ROADMAP B3):
//   split the chunks over several blocks (at B = 1 only H = 64 blocks run
//   on 132 SMs), compute C B^T once per group instead of once per head, and
//   run the products on the tensor cores.

#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads: (ty, tx)
constexpr int kTile = 64;         // chunk rows per tile; also the max P
constexpr int kMaxN = 128;
constexpr int kLdN = kMaxN + 1;   // padded row strides, 1 mod 32 words
constexpr int kLdT = kTile + 1;

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
// kTranspose.  Each row is scaled by scale[r] when scale is not null.
// 16-byte loads: width * sizeof(T) and stride * sizeof(T) are multiples of
// 16 bytes and src is 16-byte aligned (the wrapper checks).
template <typename T, bool kTranspose>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           long long stride, int rows,
                                           int width, const float* scale) {
  constexpr int vec = 16 / (int)sizeof(T);
  const int per_row = width / vec;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, v = i - r * per_row;
    float f[vec];
    repro::load16(src + r * stride + v * vec, f);
    const float s = scale ? scale[r] : 1.f;
#pragma unroll
    for (int e = 0; e < vec; ++e) {
      if (kTranspose)
        dst[(v * vec + e) * ld + r] = f[e] * s;
      else
        dst[r * ld + v * vec + e] = f[e] * s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ state_out, int L, int H, int G, int P, int N,
           int Q) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  extern __shared__ float smem[];
  float* st = smem;                  // [kTile][kLdN]  state [p][n]
  float* sC = st + kTile * kLdN;     // [kTile][kLdN]  C rows of a query tile
  float* sB = sC + kTile * kLdN;     // [kTile][kLdN]  B rows of a key tile
  float* sX = sB + kTile * kLdN;     // [kTile][kLdT]  x^T of a key tile [p][j]
  float* sAtt = sX + kTile * kLdT;   // [kTile][kLdT]  att [i][j]
  float* sdt = sAtt + kTile * kLdT;  // [Q] dt, then the state weights
  float* seg = sdt + Q;              // [Q] cumsum of dt * A

  for (int i = tid; i < kTile * kLdN; i += kThreads) st[i] = 0.f;
  const float a_h = A[h];
  const long long xrow = (long long)H * P;   // x/y elements per sequence row
  const long long bcrow = (long long)G * N;  // B/C elements per sequence row
  const T* xb = x + (long long)b * L * xrow + (long long)h * P;
  float* yb = y + (long long)b * L * xrow + (long long)h * P;
  const T* Bb = Bm + (long long)b * L * bcrow + (long long)g * N;
  const T* Cb = Cm + (long long)b * L * bcrow + (long long)g * N;
  const float* dtb = dt + (long long)b * L * H + h;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();  // the last chunk's readers of sdt and st are done
    for (int q = tid; q < Q; q += kThreads) sdt[q] = dtb[(long long)(l0 + q) * H];
    __syncthreads();
    if (tid < 32) {  // seg = inclusive cumsum of dt * A: one warp
      const int per = (Q + 31) / 32, q0 = tid * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        const int q = q0 + k;
        if (q < Q) {
          run += sdt[q] * a_h;
          seg[q] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float excl = incl - run;
      for (int k = 0; k < per; ++k) {
        const int q = q0 + k;
        if (q < Q) seg[q] += excl;
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int ni = min(kTile, Q - i0);
      stage_rows<T, false>(sC, kLdN, Cb + (long long)(l0 + i0) * bcrow, bcrow,
                           ni, N, nullptr);
      __syncthreads();
      // inter-chunk: y_i = exp(seg_i) * (C_i . state^T)
      float acc[4][4] = {};
      mma_abt<kLdN, kLdN>(acc, sC, st, N, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float e = i < ni ? expf(seg[i0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }
      // intra-chunk: key tiles at or left of the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int nj = min(kTile, Q - j0);
        __syncthreads();  // the last key tile's readers are done
        stage_rows<T, false>(sB, kLdN, Bb + (long long)(l0 + j0) * bcrow,
                             bcrow, nj, N, nullptr);
        stage_rows<T, true>(sX, kLdT, xb + (long long)(l0 + j0) * xrow, xrow,
                            nj, P, nullptr);
        __syncthreads();
        float cb[4][4] = {};
        mma_abt<kLdN, kLdN>(cb, sC, sB, N, ty, tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r, qi = i0 + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tx + 16 * c, qj = j0 + j;
            float v = 0.f;  // masked before the exp: no overflow above
            if (i < ni && qj <= qi)
              v = cb[r][c] * expf(seg[qi] - seg[qj]) * sdt[qj];
            sAtt[i * kLdT + j] = v;
          }
        }
        __syncthreads();
        mma_abt<kLdT, kLdT>(acc, sAtt, sX, nj, ty, tx);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= ni) continue;
        float* yr = yb + (long long)(l0 + i0 + i) * xrow;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P) yr[p] = acc[r][c];
        }
      }
      __syncthreads();  // sC, sB, sX, sAtt free for the next tile
    }

    // state = exp(seg_last) state + sum_j (w_j x_j) B_j^T,
    // w_j = exp(seg_last - seg_j) dt_j (written over dt)
    const float seg_last = seg[Q - 1];
    for (int q = tid; q < Q; q += kThreads)
      sdt[q] = expf(seg_last - seg[q]) * sdt[q];
    const float decay = expf(seg_last);
    float sacc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sacc[r][c] = decay * st[(ty + 16 * r) * kLdN + tx + 16 * c];
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      const int nj = min(kTile, Q - j0);
      __syncthreads();  // weights written; the last key tile's readers done
      stage_rows<T, false>(sB, kLdN, Bb + (long long)(l0 + j0) * bcrow, bcrow,
                           nj, N, nullptr);
      stage_rows<T, true>(sX, kLdT, xb + (long long)(l0 + j0) * xrow, xrow,
                          nj, P, sdt + j0);
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
          for (int c = 0; c < 8; ++c)
            sacc[r][c] = fmaf(av[r], bv[c], sacc[r][c]);
      }
    }
    __syncthreads();  // every read of the old state is done
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int n = tx + 16 * c;
        if (p < P && n < N) st[p * kLdN + n] = sacc[r][c];
      }
    }
  }
  __syncthreads();

  float* sb = state_out + ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    sb[i] = st[p * kLdN + n];
  }
}

size_t smem_bytes(int Q) {
  return (3 * (size_t)kTile * kLdN + 2 * (size_t)kTile * kLdT + 2 * (size_t)Q) *
         sizeof(float);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int Bsz, int L, int H, int G,
           int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<T><<<dim3(H, Bsz), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(state), L, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The wrapper
// guarantees L % Q == 0, H % G == 0, P <= 64 and N <= 128, both multiples
// of 8, contiguous 16-byte aligned inputs; a chunk too long for one block's
// shared memory is refused by cudaFuncSetAttribute.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, void* y, void* state,
                          int Bsz, int L, int H, int G, int P, int N, int Q,
                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bsz, L, H, G, P,
                                 N, Q, s);
  return launch<float>(x, dt, A, Bm, Cm, y, state, Bsz, L, H, G, P, N, Q, s);
}
