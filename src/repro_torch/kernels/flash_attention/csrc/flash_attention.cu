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
//   and tanh softcap after the 1/sqrt(hd) scale.  Query head h reads KV head
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
// Two kernels; the entry point routes by dtype and head dim:
//
// * bf16 with hd 64 or 128 (llama3.1-8b, qwen2.5-14b): flash_wgmma_kernel,
//   warp-specialised on the tensor cores.  One block per (128-row q tile,
//   query head, sequence), the heaviest causal q tiles launched first: two
//   consumer warpgroups own 64 q rows each, and one producer warp issues
//   TMA loads, the q tile once, then K and V tiles (64 keys at hd 128, 128
//   at hd 64) into a ring of shared-memory stages (2 at hd 128, 3 at hd
//   64).  Each stage has a full and an empty mbarrier for K and for V, so a
//   K tile is refilled as soon as its S is taken.  Per key tile a consumer
//   computes S = Q K^T with wgmma m64nBKk16 (A = Q, B = K, both K-major
//   from shared memory), takes the online softmax in registers on the
//   accumulator layout (row max and sum over the 4 threads of a row; scale,
//   softcap, then the masks, applied only on tiles that cross the diagonal,
//   the window edge or the ragged key edge), rescales O, and adds P V with
//   wgmma m64nHDk16 (A = P rounded to bf16 in registers, B = V MN-major
//   from shared memory, the transpose flag set).  S of tile i and P V of
//   tile i - 1 are issued together, so P V runs on the tensor cores while
//   the softmax of tile i runs, and the two consumers take turns to issue
//   (named barriers), so one's products run while the other's softmax
//   does.  TMA boxes are 64 columns (128 bytes) wide, the 128-byte swizzle
//   span, so an hd = 128 row is loaded and described as two boxes.  The
//   tensor maps are the 4-D [B, L, heads, hd] arrays with their real batch
//   stride, and their L extent is Lk, so a prefix buf[:, :n] of a longer
//   buffer reads zeros, not the buffer's tail, past n.  Keys at or past Lk
//   are set to -inf (a zero-filled K row scores 0, not -inf).  The
//   epilogue divides by max(l, 1e-30), stages O in bf16 over the
//   consumer's own q rows in shared memory and stores the rows below Lq
//   with 16-byte writes.
//   Registers: S, O and P of the overlapped loop must all stay in registers
//   while the products run.  At hd = 128 with 128-key tiles ptxas
//   serialised every wgmma for want of registers and spilled; 64-key tiles
//   halve S and P.  A block of 288 threads may give each thread up to 224
//   registers, so setmaxnreg, which moves registers between warpgroups at
//   run time, is not needed.
//   Numerics: P is rounded to bf16 before P V, where the Pallas kernel and
//   the plain version keep it in fp32.  P lies in [0, 1], so each weight
//   moves by at most 2^-9 of itself.  On the shapes checked on the card the
//   bf16 outputs of kernel and plain version differ by at most one bf16
//   step, within the bf16 tolerance of 2e-2 (PERF.md has the errors).
//
// * fp32 (any hd), and bf16 with hd 16, 32, 48, 80, 96 or 112:
//   flash_kernel, the first port, on the fp32 CUDA cores.  fp32 on the
//   tensor cores would be TF32, which breaks the 1e-4 fp32 tolerance.  One
//   block of 256 threads per (64-row q tile, head, sequence).  The q tile
//   stays in shared memory; 64-key tiles of K and then V pass through one
//   shared buffer (rows padded by one float against bank conflicts).  Each
//   thread owns a 4 x 4 patch of the score tile and 4 rows x hd/16 columns
//   of the output accumulator in registers; row max and row sum are reduced
//   with shuffles across the 16 threads that share a row.

#include <cuda.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32, and bf16 at head dims other than 64 and 128: plain FMAs
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 at hd 64 and 128: wgmma on the tensor cores, fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWBQ = 128;       // q rows per block: two consumers of 64
constexpr int kWThreads = 288;  // two consumer warpgroups + a producer warp
constexpr int kBox = 64;        // bf16 columns per TMA box: 128 bytes

template <int HD>
struct WCfg {
  static constexpr int kBK = HD == 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int kStages = HD == 64 ? 3 : 2;
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

// Shared memory, from a 1024-byte aligned base: q [boxes][kWBQ rows][64],
// then the K ring and the V ring, each stage [boxes][BK rows][64], all in
// TMA's 128-byte swizzle; then the mbarriers.  Consumer c's q rows are rows
// 64c..64c+63 of every box.  K and V stages are released separately: a K
// tile as soon as its S is taken, a V tile when its P V is done.
template <int HD>
__global__ void __launch_bounds__(kWThreads, 1)
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
                 float softcap, cudaStream_t stream) {
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
  flash_wgmma_kernel<HD><<<grid, kWThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), sob, Lq, Lk, H, KV, causal,
      window, softcap, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

// Which kernel a call takes: 1 for the wgmma kernel (bf16 at hd 64 or
// 128), 0 for the fp32 FMA kernel.
extern "C" int flash_attention_uses_wgmma(int is_bf16, int hd) {
  return is_bf16 && (hd == 64 || hd == 128);
}

// Batch strides are in elements; inside a sequence q/k/v/o are contiguous
// [L, heads, hd].  window <= 0 means no window, softcap <= 0 no softcap.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Lq,
                                      int Lk, int H, int KV, int hd,
                                      long long sqb, long long skb,
                                      long long svb, long long sob,
                                      int causal, int window, float softcap,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flash_attention_uses_wgmma(is_bf16, hd))
    return hd == 64 ? launch_wgmma<64>(q, k, v, o, B, Lq, Lk, H, KV, sqb, skb,
                                       svb, sob, causal, window, softcap, s)
                    : launch_wgmma<128>(q, k, v, o, B, Lq, Lk, H, KV, sqb,
                                        skb, svb, sob, causal, window,
                                        softcap, s);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb,
                                    skb, svb, sob, causal, window, softcap, s);
  return launch_hd<float>(q, k, v, o, B, Lq, Lk, H, KV, hd, sqb, skb, svb,
                          sob, causal, window, softcap, s);
}
