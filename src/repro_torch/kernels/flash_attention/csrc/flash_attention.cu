// Causal / sliding-window GQA flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   _flash_kernel (:23) / flash_attention_pallas (:79, pallas_call :103)
//   (Pallas TPU kernel).
//
// Computes: q [B, Lq, H, hd], k/v [B, Lk, KV, hd] -> o [B, Lq, H, hd].  The
//   q rows are the tail of k (q_offset = Lk - Lq), so row i sits at absolute
//   position i + Lk - Lq: that one rule carries both one-shot prefill
//   (Lq = Lk) and a prefill chunk attending over its staged prefix
//   (Lk = pos0 + C).  Optional causal mask, sliding window (ki > qi - window)
//   and tanh softcap after the scale (1/sqrt(hd), or the caller's: a muP
//   config's attention multiplier).  Query head h reads KV head
//   h / G.  Online softmax in fp32; fully masked key tiles are never visited.
//   Unlike the Pallas kernel, Lq and Lk may be any length: the ragged edges
//   of both are masked here.
//
// Bound: operations.  Causal prefill at L = 2048 does about 34 GFLOP per
//   layer against 67 MB of q/k/v/o in bf16: ~500 flops per byte, above the
//   ~295 at which Hopper's bf16 tensor cores (989 TFLOP/s), not memory
//   (3.35 TB/s), are the limit.  Only the tensor cores reach that bound:
//   the fp32 CUDA cores peak at 67 TFLOP/s.
//
// Three kernels; the entry point routes by dtype and head dim
// (flash_attention_route):
//
// * bf16 with hd 64, 128 or 256 (llama3.1-8b, qwen2.5-14b, minicpm-2b,
//   gemma3-27b; gemma3-12b at 256): flash_wgmma_kernel, warp-specialised
//   on the tensor cores.  One block per (128-row q tile, query head,
//   sequence), the heaviest causal q tiles launched first: two consumer
//   warpgroups own 64 q rows each, and a producer issues TMA loads, the q
//   tile once, then K and V tiles (128 keys at hd 64, 64 at hd 128 and
//   256) into a ring of shared-memory stages (3 at hd 64, else 2).  Each
//   stage has a full and an empty mbarrier for K and for V, so a K tile is
//   refilled as soon as its S is taken.  Per key tile a consumer computes
//   S = Q K^T with wgmma m64nBKk16 (A = Q, B = K, both K-major from shared
//   memory), takes the online softmax in registers on the accumulator
//   layout (row max and sum over the 4 threads of a row; scale, softcap,
//   then the masks, applied only on tiles that cross the diagonal, the
//   window edge or the ragged key edge), rescales O, and adds P V with
//   wgmma m64nHDk16 (A = P rounded to bf16 in registers, B = V MN-major
//   from shared memory, the transpose flag set; at hd 256 one product
//   spans the four 64-column boxes of a V row, LBO = BK * 128 bytes
//   apart).  S of tile i and P V of tile i - 1 are issued together, so P V
//   runs on the tensor cores while the softmax of tile i runs, and the two
//   consumers take turns to issue (named barriers), so one's products run
//   while the other's softmax does.  TMA boxes are 64 columns (128 bytes)
//   wide, the 128-byte swizzle span, so an hd-wide row is loaded and
//   described as hd / 64 boxes.  The tensor maps are the 4-D [B, L, heads,
//   hd] arrays with their real batch stride, and their L extent is Lk, so
//   a prefix buf[:, :n] of a longer buffer reads zeros, not the buffer's
//   tail, past n.  Keys at or past Lk are set to -inf (a zero-filled K row
//   scores 0, not -inf).  The epilogue divides by max(l, 1e-30), stages O
//   in bf16 over the consumer's own q rows in shared memory (64 rows x
//   hd / 64 boxes: 32 KB at hd 256, never the other consumer's rows) and
//   stores the rows below Lq with 16-byte writes.
//   Registers: S (BK/2 floats a thread), P (BK/4 words) and O (hd/2
//   floats) of the overlapped loop must all stay in registers while the
//   products run, or ptxas serialises every wgmma (C7512) and spills.
//   ptxas gives a block of 9 or 12 warps at most 168 registers a thread
//   (each of the SM's four 16K-register quarters holds 3 of its warps).
//   At hd 64 and 128 that is enough for 288 threads, two consumers and
//   one producer warp (O + S + P: 32 + 64 + 32 and 64 + 32 + 16 live).
//   At hd 256 O alone is 128, and 64-key tiles make 128 + 32 + 16 = 176
//   live: with 288 threads and 32-key tiles (152 live) ptxas still
//   reported C7512 and 428 bytes of spill stores, and the call took
//   0.164 ms at gemma3-12b's shape on an H100 (PERF.md).  So hd 256 runs
//   384 threads: the producer is a whole warpgroup that drops to 40
//   registers (setmaxnreg.dec) and the consumers rise to 232
//   (setmaxnreg.inc; 40 + 2 x 232 = 504 of a quarter's 512 a lane).
//   ptxas then reports no spill and no C7512; its "Used 168 registers"
//   is the launch count, and the consumers' SASS reaches R228
//   (cuobjdump).  Shared memory: q 64 KB, two stages of K and V 128 KB
//   (193 KB with the barriers and the alignment slack), one block an SM;
//   gemma3-12b's 2000-row prefill is 16 heads x 16 q tiles = 256 blocks,
//   1.94 waves over 132 SMs.
//   Numerics: P is rounded to bf16 before P V, where the Pallas kernel and
//   the plain version keep it in fp32.  P lies in [0, 1], so each weight
//   moves by at most 2^-9 of itself.  On the shapes checked on the card the
//   bf16 outputs of kernel and plain version differ by at most one bf16
//   step, within the bf16 tolerance of 2e-2 (PERF.md has the errors).
//
// * fp32 with hd 16, 32, 64 or 128 (the JAX engine's dtype: llama3.1-8b,
//   minicpm-2b, the window layers, the reduced configs):
//   flash_tf32x3_kernel, on the tensor cores with mma.sync.m16n8k8 TF32;
//   like the other two it replaces _flash_kernel.  One TF32 product (10 mantissa bits) errs by ~1e-3 here, past the 1e-4
//   fp32 tolerance, so every operand x is split into hi = x rounded to
//   TF32 and lo = (x - hi) rounded to TF32, and each product is three,
//   lo.hi + hi.lo + hi.hi, added small terms first into fp32 (lo.lo,
//   ~2^-22 of it, is left out): fp32's accuracy (the card's errors against
//   the plain version are in PERF.md) at three times TF32's work, so the
//   bound is 3 x flops over TF32's 494.7 TFLOP/s, 0.199 ms for
//   llama3.1-8b's 2000-token causal prefill.  Q, K, V and P are all split,
//   P in registers, Q, K and V as each warp reads its fragments from
//   shared memory.  One block of 256 threads per (128-row q tile, head,
//   sequence), heaviest causal tiles first; each warp owns 16 q rows.  Q
//   stays in shared memory; 64-key tiles of K and V come in with cp.async
//   into two stages, the next tile loading while this one is used.  The
//   fragments are read as 16-byte vectors: Q and K by head dim permuted
//   within 16 (the same order on both sides of the sum), V by 4 columns
//   of a row with the output columns permuted to match; row strides padded
//   so those reads hit distinct banks.  S's accumulator layout is P V's A
//   layout with each 8-key step's keys permuted (V's rows read to match),
//   so P never leaves registers.  The online softmax, the masks, the
//   ragged edges and the tail alignment are the wgmma kernel's, decided
//   per warp: a warp skips a tile none of whose keys its rows see.  Rows
//   past Lq or Lk load as zeros (cp.async zero-fill), so a prefix buf[:,
//   :n] of a longer buffer is never read past n.  Bound on this card by
//   instruction issue: the split is 5 integer and float instructions an
//   element, and each warp splits every K and V element of every tile it
//   reads (512 a thread a tile at hd 128, against 768 HMMA a warp), so
//   the splits outnumber the products.  ptxas reports under 200 registers
//   at hd 128 and no spill (chip_smoke.py phase 1 prints it); 256
//   threads, one block an SM (210 KB of shared memory at hd 128).
//
// * fp32 with hd 48, 80, 96, 112 or 256, and bf16 with hd 16, 32, 48, 80,
//   96 or 112: flash_kernel, the first port, on the fp32 CUDA cores.
//   One block of 256 threads per (64-row q tile, head, sequence).  The q
//   tile stays in shared memory; 64-key tiles of K and then V pass through
//   one shared buffer (rows padded by one float against bank conflicts).
//   Each thread owns a 4 x 4 patch of the score tile and 4 rows x hd/16
//   columns of the output accumulator in registers; row max and row sum
//   are reduced with shuffles across the 16 threads that share a row.  At
//   hd 256 (fp32 only) that is 64 accumulators a thread, and q, the K/V
//   tile and P take 148 KB of dynamic shared memory: one block an SM.

#include <cuda.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32, and bf16 at head dims other than 64, 128 and 256: plain FMAs
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns

// NJ: hd / 16 rounded up to the instantiation (4 for hd <= 64, 8 for <= 128,
// 16 for 256, fp32 only)
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
           int window, float softcap, float scale, cudaStream_t stream) {
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
      skb, svb, sob, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Lq, int Lk, int H, int KV, int hd, long long sqb,
              long long skb, long long svb, long long sob, int causal,
              int window, float softcap, float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 4>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb, skb, svb, sob,
                        causal, window, softcap, scale, stream);
  if (hd <= 128)
    return launch<T, 8>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb, skb, svb, sob,
                        causal, window, softcap, scale, stream);
  if constexpr (sizeof(T) == 4) {  // bf16 at hd 256 runs on wgmma
    if (hd == 256)
      return launch<T, 16>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb, skb, svb,
                           sob, causal, window, softcap, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 128 and 256: wgmma on the tensor cores, fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWBQ = 128;  // q rows per block: two consumers of 64
constexpr int kBox = 64;   // bf16 columns per TMA box: 128 bytes

// Keys per K/V tile, ring stages and threads (see the header).  S (BK/2
// floats a thread), P (BK/4 words) and O (HD/2 floats) of the overlapped
// loop must all stay in a consumer's registers, and q plus the ring in
// 227 KB of shared memory.
template <int HD>
struct WCfg {
  static constexpr int kBK = HD == 64 ? 128 : 64;
  static constexpr int kStages = HD == 64 ? 3 : 2;
  // 288: two consumer warpgroups and a producer warp, 168 registers a
  // thread.  384 (hd 256): the producer is a warpgroup that gives
  // registers to the consumers with setmaxnreg.
  static constexpr int kThreads = HD == 256 ? 384 : 288;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kBoxes = HD / kBox;      // boxes per row
  static constexpr int kQBytes = kWBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;
  // q, the K ring, the V ring, 1 + 4 * stages mbarriers, 1 KB of slack to
  // align the base to the 1024-byte period of the 128-byte swizzle
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B from shared memory, both
// K-major (128B swizzle).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A and B from shared memory, both
// K-major (128B swizzle).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A from registers, B from shared
// memory, MN-major (transposed, 128B swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]; A from registers, B from shared
// memory, MN-major (transposed, 128B swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]; A from registers, B from shared
// memory, MN-major (transposed, 128B swizzle): four 64-column boxes, LBO
// bytes apart.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n64(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_n128(d, da, db, scale_d);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(d, a, db);
}

// Shared memory, from a 1024-byte aligned base: q [boxes][kWBQ rows][64],
// then the K ring and the V ring, each stage [boxes][BK rows][64], all in
// TMA's 128-byte swizzle; then the mbarriers.  Consumer c's q rows are rows
// 64c..64c+63 of every box.  K and V stages are released separately: a K
// tile as soon as its S is taken, a V tile when its P V is done.
template <int HD>
__global__ void __launch_bounds__(WCfg<HD>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, long long sob, int Lq,
                   int Lk, int H, int KV, int causal, int window,
                   float softcap, float scale) {
  using C = WCfg<HD>;
  constexpr int NS = C::kStages;
  constexpr int BK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sq = smem_u32(base);
  const uint32_t sk = sq + C::kQBytes;
  const uint32_t sv = sk + NS * C::kKVBytes;
  const uint32_t q_full = sv + NS * C::kKVBytes;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + NS + s); };
  auto empty_k = [&](int s) { return q_full + 8 * (1 + 2 * NS + s); };
  auto empty_v = [&](int s) { return q_full + 8 * (1 + 3 * NS + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWBQ;  // heaviest first
  const int kvh = h / (H / KV);
  const int off = Lk - Lq;

  // the keys any row of this block can see, in whole tiles
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int k_hi = causal ? min(Lk, min(q0 + kWBQ, Lq) + off) : Lk;
  const int kt0 = k_lo / BK * BK;
  const int n_tiles = (k_hi - kt0 + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 256);  // every consumer thread arrives
      mbar_init(empty_v(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    if constexpr (C::kThreads == 384)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          C::kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(sq + c * kWBQ * 128, &qmap, q_full, c * kBox, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        const uint32_t free_par = ((i / NS) & 1) ^ 1;
        const int kt = kt0 + i * BK;
        mbar_wait(empty_k(s), free_par);
        mbar_expect_tx(full_k(s), C::kKVBytes);
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(sk + s * C::kKVBytes + c * BK * 128, &kmap, full_k(s),
                   c * kBox, kvh, kt, b);
        mbar_wait(empty_v(s), free_par);
        mbar_expect_tx(full_v(s), C::kKVBytes);
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(sv + s * C::kKVBytes + c * BK * 128, &vmap, full_v(s),
                   c * kBox, kvh, kt, b);
      }
    }
  } else {
    // ---- consumers ----
    if constexpr (C::kThreads == 384)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          C::kConsumerRegs));
    const int cw = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_loc = (t / 32) * 16 + (lane >> 2);  // rows r_loc, r_loc + 8
    const int row0 = q0 + 64 * cw;                  // first q row of cw
    const int qi0 = row0 + r_loc + off;             // absolute positions
    const int qi1 = qi0 + 8;
    const bool live = row0 < Lq;
    // the block's first and last q positions: whether a tile needs masks is
    // decided for the whole block, from values every thread shares
    const int b_lo = q0 + off;
    const int b_hi = min(q0 + kWBQ, Lq) - 1 + off;
    const uint32_t qa = sq + cw * 64 * 128;
    // scores stay unscaled; exp(scale x - scale m) = 2^(mul x - mul m).
    // With a softcap the capped, scaled score is what the max runs over.
    constexpr float kLog2e = 1.4426950408889634f;
    const float mul = softcap > 0.f ? kLog2e : scale * kLog2e;
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f;

    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float a0, a1;

    // S = Q K^T of the tile in stage st, issued, not waited for
    auto issue_qk = [&](int st) {
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t ko = (kk / 4) * kWBQ * 128 + (kk % 4) * 32;
        const uint32_t kko = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_qk<BK>(s, sw128_desc(qa + ko, 16, 1024),
                     sw128_desc(sk + st * C::kKVBytes + kko, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage st, issued, not waited for
    auto issue_pv = [&](int st) {
      reg_fence(oacc);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < BK / 16; ++u)
        wgmma_pv<HD>(oacc, pa[u],
                     sw128_desc(sv + st * C::kKVBytes + u * 16 * 128,
                                BK * 128, 1024));
      wgmma_commit();
    };
    // online softmax of the tile at key kt, in place on s: s becomes P in
    // fp32, (a0, a1) the factors that rescale O, m and l move on.
    // s[4j + e] is row r_loc (+8 for e >= 2), key kt + 8j + 2(lane%4) + e%2.
    auto softmax = [&](int kt) {
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          s[j] = tanhf(s[j] * cap_in) * softcap;
      }
      // mask only tiles that cross the diagonal, the window's edge or Lk
      if ((causal && kt + BK - 1 > b_lo) ||
          (window > 0 && kt <= b_hi - window) || kt + BK > Lk) {
        const int kc = kt + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ki = kc + 8 * j + (e & 1);
            const int qi = e < 2 ? qi0 : qi1;
            bool ok = ki < Lk;
            if (causal) ok = ok && ki <= qi;
            if (window > 0) ok = ok && ki > qi - window;
            if (!ok) s[4 * j + e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // a row that has seen no key yet keeps m = -inf and l = 0
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float mb0 = (mn0 == -INFINITY ? 0.f : mn0) * mul;
      const float mb1 = (mn1 == -INFINITY ? 0.f : mn1) * mul;
      a0 = ex2(fmaf(m0, mul, -mb0));
      a1 = ex2(fmaf(m1, mul, -mb1));
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], mul, -mb0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], mul, -mb0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], mul, -mb1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], mul, -mb1));
        rs0 += s[4 * j] + s[4 * j + 1];
        rs1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + rs0;  // this thread's share; summed over the quad last
      l1 = l1 * a1 + rs1;
    };
    // rescale O, and write P as the register-A operand of the next P V: the
    // accumulator layout of keys 16u..16u+15 is the A layout of k-step u
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        oacc[4 * j] *= a0;
        oacc[4 * j + 1] *= a0;
        oacc[4 * j + 2] *= a1;
        oacc[4 * j + 3] *= a1;
      }
#pragma unroll
      for (int u = 0; u < BK / 16; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[u][r] = pack_bf16(s[8 * u + 2 * r], s[8 * u + 2 * r + 1]);
    };

    // Every tile of the block runs on both consumers, whatever their rows
    // see: a tile masked out for a consumer's rows adds P = 0.  No wgmma is
    // issued or waited for under a data-dependent branch, so ptxas keeps
    // them asynchronous.  Tile i overlaps its softmax with P V of tile
    // i - 1: both products are issued, S_i is waited for, and P V runs on
    // the tensor cores while the softmax of S_i runs.  The consumers issue
    // in turn (named barriers 3 and 4, consumer 0 first), so the products of
    // one run while the other computes its softmax.
    mbar_wait(q_full, 0);
    if (cw == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    mbar_wait(full_k(0), 0);
    issue_qk(0);
    wgmma_wait<0>();
    reg_fence(s);
    softmax(kt0);
    mbar_arrive(empty_k(0));
    rescale_and_pack();
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % NS;
      const int sp = (i - 1) % NS;
      mbar_wait(full_k(st), (i / NS) & 1);
      mbar_wait(full_v(sp), ((i - 1) / NS) & 1);
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");  // my turn
      issue_qk(st);
      issue_pv(sp);
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
      wgmma_wait<1>();  // S_i is done; P V may still run
      reg_fence(s);
      softmax(kt0 + i * BK);
      mbar_arrive(empty_k(st));
      wgmma_wait<0>();
      reg_fence(oacc);
      mbar_arrive(empty_v(sp));
      rescale_and_pack();
    }
    if (cw == 0) asm volatile("bar.sync 3, 256;\n" ::: "memory");
    const int sl = (n_tiles - 1) % NS;
    mbar_wait(full_v(sl), ((n_tiles - 1) / NS) & 1);
    issue_pv(sl);
    wgmma_wait<0>();
    reg_fence(oacc);
    mbar_arrive(empty_v(sl));

    if (live) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      // stage O in bf16 over cw's own q rows (swizzled like them), then
      // write whole 16-byte pieces of the rows below Lq
      uint8_t* stage = base + cw * 64 * 128;
      auto piece = [&](int row, int col) {  // col: a multiple of 8
        return stage + (col / kBox) * kWBQ * 128 + row * 128 +
               ((((col % kBox) / 8) ^ (row & 7)) * 16);
      };
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j;
        const int within = 4 * (lane & 3);  // bytes into the 16-byte piece
        *reinterpret_cast<uint32_t*>(piece(r_loc, col) + within) =
            pack_bf16(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(piece(r_loc + 8, col) + within) =
            pack_bf16(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      constexpr int kPieces = HD / 8;
      for (int idx = t; idx < 64 * kPieces; idx += 128) {
        const int row = idx / kPieces, pc = idx % kPieces;
        const int r = row0 + row;
        if (r < Lq)
          *reinterpret_cast<uint4*>(o + b * sob + (size_t)r * H * HD +
                                    (size_t)h * HD + pc * 8) =
              *reinterpret_cast<const uint4*>(piece(row, pc * 8));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 at hd 16, 32, 64 and 128: split TF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int kTBQ = 128;      // q rows per block: 8 warps of 16
constexpr int kTBK = 64;       // keys per K/V tile
constexpr int kTThreads = 256;

// Row strides (floats) and the V column grouping.  Q and K fragments are
// 16-byte reads of rows g and g + 1 by lanes 4g + tig (a phase of 8
// lanes): a stride of 16 mod 32 floats puts the 8 reads in 8 distinct
// bank quads.  V fragments are reads of kNU floats from rows 2 tig and
// 2 tig + 1: a stride of 4 mod 8 does the same for them.
template <int HD>
struct TCfg {
  static constexpr int kLdQK = HD + ((16 - HD % 32) & 31);
  static constexpr int kLdV = HD + 4;
  static constexpr int kNU = HD >= 32 ? 4 : 2;  // n-tiles of a column group
  static constexpr int kGW = 8 * kNU;           // columns of a group
  static constexpr int kSmem =
      4 * (kTBQ * kLdQK + 2 * kTBK * kLdQK + 2 * kTBK * kLdV);
};

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

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds finite values: add half of the 13 dropped bits'
// unit and clear them.  Two integer instructions; ptxas expands the cvt
// into a NaN test, selects and more, and the kernel is bound by issue.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi is x rounded to TF32, lo the remainder rounded to TF32;
// hi + lo holds x to about 2^-22 of it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += A B, one m16n8k8 TF32 product with an fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B to about fp32 accuracy: lo.hi, then hi.lo, then hi.hi (the
// small terms first); lo.lo, about 2^-22 of the product, is left out.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

// Shared memory: q [kTBQ][kLdQK], then two stages of K [kTBK][kLdQK] and two
// of V [kTBK][kLdV], raw fp32 loaded with cp.async (rows past Lq or Lk are
// zero-filled, never read).  Warp w owns q rows 16w..16w+15 of the block.
// Fragments (g = lane / 4, tig = lane % 4; m16n8k8 layouts):
// * S = Q K^T takes head dims 16 at a time: lane reads d = 16p + 4 tig ..
//   + 3 of its rows as one 16-byte vector, and k-step 2p takes d + 0 and
//   + 1 as its columns tig and tig + 4, k-step 2p + 1 takes d + 2 and + 3.
//   Q and K use the same order, so the sum over d is unchanged.
// * S's accumulator of n-tile j holds keys 8j + 2 tig and + 1 of rows g and
//   g + 8; P V's k-step j takes them as its columns tig and tig + 4, so P
//   goes from accumulator to A operand in place, and V's B operand reads
//   rows 8j + 2 tig and 8j + 2 tig + 1.
// * P V's n-tile grp * kNU + u, column g, is head dim grp * kGW + kNU g + u,
//   so a lane reads kNU columns of a V row as one vector and ends up with
//   2 kNU contiguous columns of O in each of its rows.
template <int HD>
__global__ void __launch_bounds__(kTThreads, 1)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int Lq, int Lk, int H, int KV, long long sqb,
                    long long skb, long long svb, long long sob, int causal,
                    int window, float softcap, float scale) {
  using C = TCfg<HD>;
  constexpr int LQK = C::kLdQK, LV = C::kLdV, NU = C::kNU, GW = C::kGW;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* ks = qs + kTBQ * LQK;
  float* vs = ks + 2 * kTBK * LQK;

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTBQ;  // heaviest first
  const int kvh = h / (H / KV);
  const int off = Lk - Lq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;

  const float* qb = q + b * sqb + (size_t)h * HD;
  const float* kb = k + b * skb + (size_t)kvh * HD;
  const float* vb = v + b * svb + (size_t)kvh * HD;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;

  // `rows` rows from `first` into dst; rows at or past `limit` are zeros
  auto load_rows = [&](const float* base, size_t stride, int first,
                       int limit, int rows, float* dst, int ld) {
    constexpr int kChunks = HD / 4;
    for (int i = tid; i < rows * kChunks; i += kTThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      const bool in = first + r < limit;
      cp_async16(smem_u32(dst + r * ld + 4 * c),
                 in ? base + (size_t)(first + r) * stride + 4 * c : base,
                 in ? 16 : 0);
    }
  };

  // the keys any row of this block can see, in whole tiles
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int k_hi = causal ? min(Lk, min(q0 + kTBQ, Lq) + off) : Lk;
  const int kt0 = k_lo / kTBK * kTBK;
  const int n_tiles = (k_hi - kt0 + kTBK - 1) / kTBK;

  load_rows(qb, q_row, q0, Lq, kTBQ, qs, LQK);
  load_rows(kb, kv_row, kt0, Lk, kTBK, ks, LQK);
  load_rows(vb, kv_row, kt0, Lk, kTBK, vs, LV);
  cp_async_commit();

  const int r0 = q0 + 16 * warp;           // this warp's first q row
  const bool live = r0 < Lq;
  const int qi0 = r0 + g + off, qi1 = qi0 + 8;  // absolute positions
  // the warp's first and last live positions: whether a tile counts or
  // needs masks is decided for the whole warp
  const int w_lo = r0 + off;
  const int w_hi = min(r0 + 15, Lq - 1) + off;
  // scores stay unscaled; exp(scale x - scale m) = 2^(mul x - mul m).
  // With a softcap the capped, scaled score is what the max runs over.
  constexpr float kLog2e = 1.4426950408889634f;
  const float mul = softcap > 0.f ? kLog2e : scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;

  float oacc[HD / 8][4];
#pragma unroll
  for (int t = 0; t < HD / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[t][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    const int kt = kt0 + i * kTBK;
    // prefetch the next tile into the other stage, which every warp left
    // at the barrier that closed the previous tile
    if (i + 1 < n_tiles) {
      load_rows(kb, kv_row, kt + kTBK, Lk, kTBK, ks + (st ^ 1) * kTBK * LQK,
                LQK);
      load_rows(vb, kv_row, kt + kTBK, Lk, kTBK, vs + (st ^ 1) * kTBK * LV,
                LV);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    bool run = live;  // a tile all of whose keys are masked adds nothing
    if (causal) run = run && kt <= w_hi;
    if (window > 0) run = run && kt + kTBK - 1 > w_lo - window;
    if (run) {
      // ---- S = Q K^T: 8 n-tiles of 8 keys ----
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const float* qw = qs + (16 * warp + g) * LQK + 4 * tig;
      const float* kw = ks + st * kTBK * LQK + g * LQK + 4 * tig;
#pragma unroll
      for (int p = 0; p < HD / 16; ++p) {
        const float4 x0 = *reinterpret_cast<const float4*>(qw + 16 * p);
        const float4 x1 =
            *reinterpret_cast<const float4*>(qw + 8 * LQK + 16 * p);
        uint32_t ah[2][4], al[2][4];
        split_tf32(x0.x, ah[0][0], al[0][0]);
        split_tf32(x1.x, ah[0][1], al[0][1]);
        split_tf32(x0.y, ah[0][2], al[0][2]);
        split_tf32(x1.y, ah[0][3], al[0][3]);
        split_tf32(x0.z, ah[1][0], al[1][0]);
        split_tf32(x1.z, ah[1][1], al[1][1]);
        split_tf32(x0.w, ah[1][2], al[1][2]);
        split_tf32(x1.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 y =
              *reinterpret_cast<const float4*>(kw + 8 * j * LQK + 16 * p);
          uint32_t bh[4], bl[4];
          split_tf32(y.x, bh[0], bl[0]);
          split_tf32(y.y, bh[1], bl[1]);
          split_tf32(y.z, bh[2], bl[2]);
          split_tf32(y.w, bh[3], bl[3]);
          mma_3xtf32(s[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(s[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
        }
      }

      // ---- online softmax, in place on s: s[j][e] is row g (+8 for e >=
      // 2), key kt + 8j + 2 tig + e % 2 ----
      if (softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = tanhf(s[j][e] * cap_in) * softcap;
      }
      // mask only tiles that cross the diagonal, the window's edge or Lk
      if ((causal && kt + kTBK - 1 > w_lo) ||
          (window > 0 && kt <= w_hi - window) || kt + kTBK > Lk) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ki = kt + 8 * j + 2 * tig + (e & 1);
            const int qi = e < 2 ? qi0 : qi1;
            bool ok = ki < Lk;
            if (causal) ok = ok && ki <= qi;
            if (window > 0) ok = ok && ki > qi - window;
            if (!ok) s[j][e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // a row that has seen no key yet keeps m = -inf and l = 0
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float mb0 = (mn0 == -INFINITY ? 0.f : mn0) * mul;
      const float mb1 = (mn1 == -INFINITY ? 0.f : mn1) * mul;
      const float a0 = ex2(fmaf(m0, mul, -mb0));
      const float a1 = ex2(fmaf(m1, mul, -mb1));
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = ex2(fmaf(s[j][0], mul, -mb0));
        s[j][1] = ex2(fmaf(s[j][1], mul, -mb0));
        s[j][2] = ex2(fmaf(s[j][2], mul, -mb1));
        s[j][3] = ex2(fmaf(s[j][3], mul, -mb1));
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
      }
      l0 = l0 * a0 + rs0;  // this thread's share; summed over the quad last
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int t = 0; t < HD / 8; ++t) {
        oacc[t][0] *= a0;
        oacc[t][1] *= a0;
        oacc[t][2] *= a1;
        oacc[t][3] *= a1;
      }

      // ---- O += P V: 8 k-steps of 8 keys, P split like Q and K ----
      const float* vw = vs + st * kTBK * LV + 2 * tig * LV + NU * g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* v0 = vw + 8 * j * LV;  // key 8j + 2 tig
#pragma unroll
        for (int grp = 0; grp < HD / GW; ++grp) {
          float x[NU], y[NU];  // rows 8j + 2 tig and 8j + 2 tig + 1
          if constexpr (NU == 4) {
            const float4 a = *reinterpret_cast<const float4*>(v0 + grp * GW);
            const float4 c =
                *reinterpret_cast<const float4*>(v0 + LV + grp * GW);
            x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
            y[0] = c.x, y[1] = c.y, y[2] = c.z, y[3] = c.w;
          } else {
            const float2 a = *reinterpret_cast<const float2*>(v0 + grp * GW);
            const float2 c =
                *reinterpret_cast<const float2*>(v0 + LV + grp * GW);
            x[0] = a.x, x[1] = a.y;
            y[0] = c.x, y[1] = c.y;
          }
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(x[u], bh0, bl0);
            split_tf32(y[u], bh1, bl1);
            mma_3xtf32(oacc[grp * NU + u], ph, pl, bh0, bh1, bl0, bl1);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
  // row g (half 0) and g + 8 (half 1): columns grp * GW + 2 NU tig .. + 2 NU
  // - 1 hold oacc[grp * NU + u][2 half + c] at offset NU c + u
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= Lq) continue;
    float* orow = o + b * sob + (size_t)r * q_row + (size_t)h * HD;
#pragma unroll
    for (int grp = 0; grp < HD / GW; ++grp) {
      float out[2 * NU];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int u = 0; u < NU; ++u)
          out[NU * c + u] = oacc[grp * NU + u][2 * half + c] * inv[half];
#pragma unroll
      for (int w = 0; w < 2 * NU / 4; ++w)
        *reinterpret_cast<float4*>(orow + grp * GW + 2 * NU * tig + 4 * w) =
            make_float4(out[4 * w], out[4 * w + 1], out[4 * w + 2],
                        out[4 * w + 3]);
    }
  }
}

template <int HD>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o,
                  int B, int Lq, int Lk, int H, int KV, long long sqb,
                  long long skb, long long svb, long long sob, int causal,
                  int window, float softcap, float scale,
                  cudaStream_t stream) {
  const int smem = TCfg<HD>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32x3_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, (Lq + kTBQ - 1) / kTBQ, B);
  flash_tf32x3_kernel<HD><<<grid, kTThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Lq, Lk, H, KV, sqb,
      skb, svb, sob, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library, which the runtime
// reaches for us: no -lcuda at build time.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, L, heads, hd] array with batch stride sb (elements) as a 4-D
// TMA map over (hd, heads, L, B); a box is 64 columns of `rows` rows of one
// head of one sequence, 128-byte swizzled.  Rows at or past L read zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int L, int heads,
             int hd, long long sb, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (B == 1) sb = (long long)L * heads * hd;  // unused; keep it in range
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Lq, int Lk, int H, int KV, long long sqb, long long skb,
                 long long svb, long long sob, int causal, int window,
                 float softcap, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int e = make_map(&qm, q, B, Lq, H, HD, sqb, kWBQ);
  if (!e) e = make_map(&km, k, B, Lk, KV, HD, skb, WCfg<HD>::kBK);
  if (!e) e = make_map(&vm, v, B, Lk, KV, HD, svb, WCfg<HD>::kBK);
  if (e) return e;
  const int smem = WCfg<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (Lq + kWBQ - 1) / kWBQ, B);
  flash_wgmma_kernel<HD><<<grid, WCfg<HD>::kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), sob, Lq, Lk, H, KV, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

// The three kernels a call can take (ops.py names them).
enum Route { kFma = 0, kWgmma = 1, kTf32x3 = 2 };

}  // namespace

// Which kernel a call takes: the wgmma kernel for bf16 at hd 64, 128 or
// 256, the split-TF32 kernel for fp32 at hd 16, 32, 64 or 128, the FMA
// kernel for the rest.
extern "C" int flash_attention_route(int is_bf16, int hd) {
  if (is_bf16) return hd == 64 || hd == 128 || hd == 256 ? kWgmma : kFma;
  return hd == 16 || hd == 32 || hd == 64 || hd == 128 ? kTf32x3 : kFma;
}

// Batch strides are in elements; inside a sequence q/k/v/o are contiguous
// [L, heads, hd].  hd: a multiple of 16 up to 128, or 256.  window <= 0
// means no window, softcap <= 0 no softcap, scale <= 0 the scale
// 1/sqrt(hd).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Lq,
                                      int Lk, int H, int KV, int hd,
                                      long long sqb, long long skb,
                                      long long svb, long long sob,
                                      int causal, int window, float softcap,
                                      float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = scale > 0.f ? scale : 1.0f / sqrtf((float)hd);
  const int route = flash_attention_route(is_bf16, hd);
  if (route == kWgmma) {
    decltype(&launch_wgmma<64>) fn = hd == 64    ? &launch_wgmma<64>
                                     : hd == 128 ? &launch_wgmma<128>
                                                 : &launch_wgmma<256>;
    return fn(q, k, v, o, B, Lq, Lk, H, KV, sqb, skb, svb, sob, causal,
              window, softcap, sc, s);
  }
  if (route == kTf32x3) {
    decltype(&launch_tf32x3<64>) fn = hd == 16   ? &launch_tf32x3<16>
                                      : hd == 32 ? &launch_tf32x3<32>
                                      : hd == 64 ? &launch_tf32x3<64>
                                                 : &launch_tf32x3<128>;
    return fn(q, k, v, o, B, Lq, Lk, H, KV, sqb, skb, svb, sob, causal,
              window, softcap, sc, s);
  }
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb,
                                    skb, svb, sob, causal, window, softcap,
                                    sc, s);
  return launch_hd<float>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb, skb, svb,
                          sob, causal, window, softcap, sc, s);
}
