// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// (loaded with ctypes by repro_torch/kernels/flash_attention.py).
//
// Replaces the Pallas kernel flash_attention_fwd (_flash_kernel) of
// src/repro/kernels/flash_attention.py: GQA online-softmax attention over
// q (B,Sq,H,D) and k, v (B,Skv,KV,D), query head h reading kv head
// h / (H/KV), with fp32 scores, running max and sum, the masks kpos < Skv,
// causal kpos <= qpos and window kpos > qpos - W filled with -1e30 (never
// -inf: a row whose first visited tile is wholly masked is wiped later by
// exp(m_prev - m_new) = 0, as in the reference), and the output
// acc / max(l, 1e-30) in q's dtype.  The TPU kernel carries m, l and acc in
// VMEM scratch across the sequential innermost grid axis; here one block
// owns a (batch, head, q tile) and loops over the kv tiles itself, holding
// m, l and acc in registers.  Nothing carries over between blocks, there are
// no atomics and the kv order is fixed, so two calls give the same bits.
// Tiles wholly past the causal diagonal or wholly before the sliding window
// are skipped, and q tiles are issued heaviest first.
//
// Bound: operations.  At the prefill shape (B,S,H,KV,D) = (4,2048,32,4,64),
// causal, the two products take 4*B*H*D*S*(S+1)/2 = 6.875e10 FLOP against
// 75.5 MB of q, k, v and o: 0.0695 ms at the 989 TFLOP/s bf16 tensor-core
// peak against 0.023 ms at 3.35 TB/s.
//
// bf16 inputs: flash_fwd_wgmma, on the tensor cores.  A block is NWG
// consumer warpgroups of 64 q rows each and one producer warp.  One lane of
// the producer copies the Q tile once and the K and V tiles of 64 rows
// through a ring of 2-4 stages with TMA (cp.async.bulk.tensor over 4-D
// tensor maps of the strided inputs, 128-byte swizzle, zero fill past Skv
// and past the head dim), each stage with a `full` mbarrier (the copy's
// bytes landed) and an `empty` one (every consumer warp is done with it),
// so copies run ahead of the products without any block-wide barrier.  S =
// Q.K^T is wgmma.m64n64k16 with both operands read from shared memory
// through descriptors; O += P.V is wgmma.m64nDk16 with P as the register A
// operand and V read MN-major, so P never touches shared memory.  Sums are
// fp32.  Within a warpgroup S(i) and P(i-1).V(i-1) are issued together and
// the softmax of S(i) runs while P(i-1).V(i-1) is on the tensor cores.  The
// score accumulators are the softmax's working set: scaled in fp32 by
// scale*log2(e) after the product (never bf16 q * scale, which rounds at
// D 112 or 128), masked only on tiles that cross a mask edge (elsewhere the
// scale rides in the FMA of the exponent's argument: one FFMA and one
// ex2.approx per score), row max and sum reduced over the 4 lanes that
// share a row, O rescaled once per kv tile.  P is rounded to bf16 in registers (the
// accumulator layout of two 8-column score groups is the A layout of one
// 16-deep k step), as the model's plain paths round the probabilities
// before the product with V; the row sum l adds the unrounded fp32 P, as
// models/attention.py::_kv_step does.  The output goes through shared
// memory to 16-byte stores.  By padded head dim (D <= 64 runs as 64, 112 as
// 128): 3 warpgroups and 4 stages at 64, 2 and 3 at 128, 1 and 2 at 256
// (160 KB of shared memory).  Operands must be 16-byte aligned with strides
// a multiple of 8 elements and D a multiple of 8; the wrapper copies or pads
// what is not.
//
// fp32 inputs: flash_fwd, on the CUDA cores in fp32, as the TPU kernel
// computes (it casts q, k, v and p to f32).  The reference's fp32 tolerance
// of 2e-5 rules out TF32 (10 mantissa bits) and bf16 products on the tensor
// cores.  256 threads as a 16 x 16 grid; thread (ty, tx) owns score rows
// 4*ty..4*ty+3 and columns tx + 16*j of each 64 x BK score tile, and the
// same rows and columns tx + 16*c of the 64 x D output, so a row's running
// max, sum and rescale stay in the 16 lanes of one half-warp.  Q (pre-scaled
// by 1/sqrt(D), as the TPU kernel scales it), K, V and P tiles live in
// shared memory as fp32, padded against bank conflicts.  At D 256 the kv
// tile is 32 rows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's fill, never -inf

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sq, skv, group, d, h, nq;
  int64_t q_sb, q_ss, q_sh;  // batch, sequence and head strides (elements)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int causal;
  int64_t window;
  float scale;
};

// ---------------------------------------------------------------------
// fp32: SIMT kernel
// ---------------------------------------------------------------------
constexpr int kBlockQ = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;           // score and output rows per thread

template <int DP, int BK>
constexpr size_t smem_floats() {
  return kBlockQ * (DP + 4) + BK * (DP + 1) + BK * DP + kBlockQ * (BK + 4);
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int CS = BK / 16;  // score columns per thread
  constexpr int CO = DP / 16;  // output columns per thread
  constexpr int QS = DP + 4, KS = DP + 1, PS = BK + 4;  // padded row strides
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * QS;
  float* vs = ks + BK * KS;
  float* ps = vs + BK * DP;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t q0 =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const int64_t kvh = hh / p.group;
  const float* qg = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* kg =
      static_cast<const float*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  for (int i = tid; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int64_t qpos = q0 + r;
    float x = 0.f;
    if (qpos < p.sq && c < p.d) x = qg[qpos * p.q_ss + c] * p.scale;
    qs[r * QS + c] = x;
  }

  float m[kRows], l[kRows], acc[kRows][CO];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[r][c] = 0.f;
  }

  int64_t k_end = p.skv;
  if (p.causal && q0 + kBlockQ < k_end) k_end = q0 + kBlockQ;
  int64_t k_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) {
    k_begin = (q0 - p.window + 1) / BK * BK;
  }

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the Q tile is stored; the last tile is consumed
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const int64_t kpos = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kpos < p.skv && c < p.d) {
        kx = kg[kpos * p.k_ss + c];
        vx = vg[kpos * p.v_ss + c];
      }
      ks[r * KS + c] = kx;
      vs[r * DP + c] = vx;
    }
    __syncthreads();

    float s[kRows][CS];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < CS; ++j) s[r][j] = 0.f;
    }
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float a[kRows], b[CS];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = qs[(ty * kRows + r) * QS + c];
#pragma unroll
      for (int j = 0; j < CS; ++j) b[j] = ks[(tx + 16 * j) * KS + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < CS; ++j) s[r][j] = fmaf(a[r], b[j], s[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t qpos = q0 + ty * kRows + r;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        bool ok = kpos < p.skv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (!ok) s[r][j] = kNegInf;
        rmax = fmaxf(rmax, s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      }
      const float m_new = fmaxf(m[r], rmax);
      const float corr = expf(m[r] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float pj = expf(s[r][j] - m_new);
        ps[(ty * kRows + r) * PS + tx + 16 * j] = pj;
        rsum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      }
      l[r] = l[r] * corr + rsum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[r][c] *= corr;
    }
    __syncwarp();  // a row's P is written by the 16 lanes that read it

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pr[r] = ps[(ty * kRows + r) * PS + j];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float vj = vs[j * DP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pr[r], vj, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t qpos = q0 + ty * kRows + r;
    if (qpos >= p.sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) og[qpos * p.o_ss + col] = acc[r][c] / denom;
    }
  }
}

template <int DP, int BK>
cudaError_t launch_simt(const Params& p, int64_t b, int64_t h,
                        cudaStream_t stream) {
  const size_t bytes = smem_floats<DP, BK>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.sq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(h), static_cast<unsigned>(b));
  flash_fwd<DP, BK><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_simt(const Params& p, int64_t b, int64_t h,
                          cudaStream_t stream) {
  if (p.d <= 32) return launch_simt<32, 64>(p, b, h, stream);
  if (p.d <= 64) return launch_simt<64, 64>(p, b, h, stream);
  if (p.d <= 128) return launch_simt<128, 64>(p, b, h, stream);
  return launch_simt<256, 32>(p, b, h, stream);
}

// ---------------------------------------------------------------------
// bf16: TMA ring, producer warp, wgmma consumer warpgroups
// ---------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 2^x in one MUFU.EX2, results below 2^-126 flushed to zero (exp2f adds
// a range fix-up around it).  Only the bf16 path uses it: its P is rounded
// to bf16, whose smallest normal is also 2^-126.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma.m64nNk16 bf16 with fp32 sums.  ss: d (+)= A . B^T with A and B
// K-major in shared memory (accumulate == 0 overwrites d).  rs: d += A . B
// with A in registers (the mma.m16n8k16 A layout per warp) and B MN-major
// in shared memory (transposed).
#define WGMMA_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24),
        WGMMA_D8(32), WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24),
        WGMMA_D8(32), WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56),
        WGMMA_D8(64), WGMMA_D8(72), WGMMA_D8(80), WGMMA_D8(88),
        WGMMA_D8(96), WGMMA_D8(104), WGMMA_D8(112), WGMMA_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WGMMA_D8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N committed wgmma groups still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the registers an asynchronous wgmma writes are not read or written by
// other instructions across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address addr:
// leading and stride byte offsets (16-byte units), layout type 1 (128 B)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Byte offset of 16-byte chunk c of row r in a bf16 tile of `rows` rows
// kept as 128-byte swizzle atoms: atom c / 8 holds head-dim columns
// 64 * (c / 8) .. + 63 of every row, 128 bytes a row, with chunk c % 8 of
// row r at position (c % 8) ^ (r % 8) (the layout TMA's SWIZZLE_128B
// writes and wgmma's layout type 1 reads; atoms are 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity to complete.  A phase that
// never completes (a lost arrival) fails the launch instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n) {
    if (n == (1u << 22)) __trap();
  }
}

// a 4-D box of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

constexpr int kBlockK = 64;  // kv rows per tile of the bf16 kernel

struct TmaArgs {
  CUtensorMap q, k, v;  // (D, heads, sequence, batch), boxes 64 x 1 x rows
  Params p;
};

template <int DP, int NWG, int STAGES>
constexpr size_t tma_smem_bytes() {
  constexpr int BK = kBlockK;
  return static_cast<size_t>(NWG * 64 + 2 * STAGES * BK) * DP * sizeof(bf16) +
         16 * STAGES + 8 + 1024;
}

template <int DP, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    flash_fwd_wgmma(const __grid_constant__ TmaArgs args) {
  constexpr int BQ = NWG * 64, BK = kBlockK;
  constexpr int CH = DP / 8;  // 16-byte chunks of a row
  constexpr int NS = BK / 8;  // 8-column groups of a score tile
  constexpr int NO = DP / 8;  // 8-column groups of the output
  constexpr uint32_t QBYTES = BQ * DP * 2, KVBYTES = BK * DP * 2;
  static_assert(DP % 64 == 0, "head dim in 128-byte swizzle atoms");
  const Params& p = args.p;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t sk = sq + QBYTES;               // [STAGES]
  const uint32_t sv = sk + STAGES * KVBYTES;     // [STAGES]
  const uint32_t full = sv + STAGES * KVBYTES;   // [STAGES] mbarriers
  const uint32_t empty = full + 8 * STAGES;      // [STAGES]
  const uint32_t qbar = empty + 8 * STAGES;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // heaviest q tiles first across every (batch, head)
  const int64_t per = gridDim.x / p.nq;
  const int64_t qt = p.nq - 1 - blockIdx.x / per;
  const int64_t rest = blockIdx.x % per;
  const int hh = static_cast<int>(rest % p.h);
  const int bb = static_cast<int>(rest / p.h);
  const int kvh = static_cast<int>(hh / p.group);
  const int64_t q0 = qt * BQ;
  bf16* og = static_cast<bf16*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  int64_t k_end = p.skv;
  if (p.causal && q0 + BQ < k_end) k_end = q0 + BQ;
  int64_t k_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) {
    k_begin = (q0 - p.window + 1) / BK * BK;
  }

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NWG * 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(qbar, QBYTES);
      for (int a = 0; a < DP / 64; ++a) {
        tma_load(sq + a * BQ * 128, &args.q, qbar, 64 * a, hh,
                 static_cast<int>(q0), bb);
      }
      int i = 0;
      for (int64_t k0 = k_begin; k0 < k_end; k0 += BK, ++i) {
        const int s = i % STAGES;
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * KVBYTES);
        for (int a = 0; a < DP / 64; ++a) {
          const uint32_t off = s * KVBYTES + a * BK * 128;
          tma_load(sk + off, &args.k, full + 8 * s, 64 * a, kvh,
                   static_cast<int>(k0), bb);
          tma_load(sv + off, &args.v, full + 8 * s, 64 * a, kvh,
                   static_cast<int>(k0), bb);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows q0 + 64 wg .. + 63.  The products of a
  // tile are pipelined: S(i) = Q.K(i)^T and O += P(i-1).V(i-1) are issued
  // together, and the softmax of S(i) runs while P(i-1).V(i-1) is on the
  // tensor cores.
  float o[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;
  float sc[BK / 2];         // S(i), then its exponentials
  uint32_t pa[BK / 16][4];  // P(i-1) in bf16: A fragments of P.V
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
  float corr0 = 1.f, corr1 = 1.f;
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const int64_t q0w = q0 + wg * 64;
  const int64_t row0 = q0w + warp * 16 + g;   // this lane's first row
  const uint32_t q_wg = sq + wg * 64 * 128;

  auto issue_s = [&](int s) {
    const uint32_t ks = sk + s * KVBYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t a =
          sw128_desc(q_wg + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024);
      const uint64_t b =
          sw128_desc(ks + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024);
      wgmma_ss_n64(sc, a, b, kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int s) {
    const uint32_t vs = sv + s * KVBYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // V is MN-major: 8-row k groups 1024 bytes apart, 64-column atoms
      // BK * 128 bytes apart
      const uint64_t b = sw128_desc(vs + kk * 16 * 128, BK * 128, 1024);
      if constexpr (DP == 64) {
        wgmma_rs_n64(o, pa[kk], b);
      } else if constexpr (DP == 128) {
        wgmma_rs_n128(o, pa[kk], b);
      } else {
        wgmma_rs_n256(o, pa[kk], b);
      }
    }
    wgmma_commit();
  };
  // S(i) in sc -> its exponentials in sc, m and l updated, corr for O
  auto softmax = [&](int64_t k0) {
    // The scores are scaled in fp32 after the product.  A tile that crosses
    // a mask edge is scaled and masked here; on any other tile the scale
    // rides in the exponent's FMA, since scaling by a positive constant
    // commutes with the max.
    const bool edge = k0 + BK > p.skv || (p.causal && k0 + BK - 1 > q0w) ||
                      (p.window > 0 && k0 <= q0w + 63 - p.window);
    float f = scale_log2;
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t qpos = row0 + ((e >> 1) << 3);
          const int64_t kpos = k0 + n * 8 + 2 * t + (e & 1);
          bool ok = kpos < p.skv;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          sc[4 * n + e] = ok ? sc[4 * n + e] * scale_log2 : kNegInf;
        }
      }
      f = 1.f;
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    mx0 = fmaxf(m0, mx0 * f);
    mx1 = fmaxf(m1, mx1 * f);
    corr0 = fast_exp2(m0 - mx0);
    corr1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sc[4 * n] = fast_exp2(fmaf(sc[4 * n], f, -mx0));
      sc[4 * n + 1] = fast_exp2(fmaf(sc[4 * n + 1], f, -mx0));
      sc[4 * n + 2] = fast_exp2(fmaf(sc[4 * n + 2], f, -mx1));
      sc[4 * n + 3] = fast_exp2(fmaf(sc[4 * n + 3], f, -mx1));
      sum0 += sc[4 * n] + sc[4 * n + 1];
      sum1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
    // per-lane partial sums: the quad's lanes share corr, so they add up
    // at the end
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
  };
  // O *= corr, then P(i) to bf16 A fragments: two 8-column groups of the
  // scores are one 16-deep k step
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      fence_regs(pa[kk]);
    }
    fence_regs(o);
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with s
  };

  mbar_wait(qbar, 0);
  // the block's tiles, all loaded by the producer; this warpgroup computes
  // none past its own causal diagonal and none if all its rows lie past
  // Sq (their contributions would be exactly 0), and only releases those
  const int n_tiles = k_begin < k_end
                          ? static_cast<int>((k_end - k_begin + BK - 1) / BK)
                          : 0;
  int64_t wg_end = k_end;
  if (p.causal && q0w + 64 < wg_end) wg_end = q0w + 64;
  const int n_work = q0w < p.sq && k_begin < wg_end
                         ? static_cast<int>((wg_end - k_begin + BK - 1) / BK)
                         : 0;
  if (n_work > 0) {
    mbar_wait(full, 0);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    fence_regs(sc);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(k_begin);
    rescale_and_pack();
  }
  for (int i = 1; i < n_work; ++i) {
    const int s = i % STAGES, prev = (i - 1) % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    wgmma_fence();
    issue_s(s);
    issue_pv(prev);
    wgmma_wait<1>();  // S(i) is in; P(i-1).V(i-1) may still run
    fence_regs(sc);
    softmax(k_begin + static_cast<int64_t>(i) * BK);
    wgmma_wait<0>();
    fence_regs(o);
    release(prev);
    rescale_and_pack();
  }
  if (n_work > 0) {
    wgmma_fence();
    issue_pv((n_work - 1) % STAGES);
    wgmma_wait<0>();
    fence_regs(o);
    release((n_work - 1) % STAGES);
  }
  for (int i = n_work; i < n_tiles; ++i) {
    mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
    release(i % STAGES);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // this warp's 16 rows of the Q tile are no longer read: stage the output
  // there, in the same swizzled layout, for 16-byte stores
  unsigned char* so = smem_raw + (sq - raw);
  const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(so + swz(r0, j, BQ) + 4 * t) =
        __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(so + swz(r0 + 8, j, BQ) + 4 * t) =
        __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  __syncwarp();
  for (int c0 = lane; c0 < 16 * CH; c0 += 32) {
    const int r = c0 / CH, c = c0 % CH;
    const int rl = wg * 64 + warp * 16 + r;
    const int64_t qpos = q0 + rl;
    if (qpos < p.sq && c * 8 < p.d) {
      *reinterpret_cast<uint4*>(og + qpos * p.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(so + swz(rl, c, BQ));
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      ptr = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a (batch, sequence, heads, d) bf16 tensor with element strides sb, ss, sh
// (unit stride in d) as a 4-D tensor map read in boxes of 64 head-dim
// columns x 1 head x `rows` positions, 128-byte swizzled, zero past every
// edge
cudaError_t encode(CUtensorMap* map, const void* ptr, int64_t d,
                   int64_t heads, int64_t seq, int64_t batch, int64_t sb,
                   int64_t ss, int64_t sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP, int NWG, int STAGES>
cudaError_t launch_tma(Params p, int64_t b, int64_t h, int64_t kvh,
                       cudaStream_t stream) {
  constexpr int BQ = NWG * 64, BK = kBlockK;
  constexpr size_t bytes = tma_smem_bytes<DP, NWG, STAGES>();
  TmaArgs args;
  p.nq = (p.sq + BQ - 1) / BQ;
  args.p = p;
  cudaError_t err = encode(&args.q, p.q, p.d, h, p.sq, b, p.q_sb, p.q_ss,
                           p.q_sh, BQ);
  if (err == cudaSuccess) {
    err = encode(&args.k, p.k, p.d, kvh, p.skv, b, p.k_sb, p.k_ss, p.k_sh, BK);
  }
  if (err == cudaSuccess) {
    err = encode(&args.v, p.v, p.d, kvh, p.skv, b, p.v_sb, p.v_ss, p.v_sh, BK);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<DP, NWG, STAGES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int64_t blocks = p.nq * b * h;
  if (blocks > 0x7fffffff || p.sq > 0x7fffffff || p.skv > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  flash_fwd_wgmma<DP, NWG, STAGES>
      <<<static_cast<unsigned>(blocks), NWG * 128 + 32, bytes, stream>>>(args);
  return cudaGetLastError();
}

// by padded head dim (D <= 64 runs as 64, D = 112 as 128): consumer
// warpgroups (64 q rows each) and ring stages
cudaError_t dispatch_tma(const Params& p, int64_t b, int64_t h, int64_t kvh,
                         cudaStream_t stream) {
  if (p.d <= 64) return launch_tma<64, 3, 4>(p, b, h, kvh, stream);
  if (p.d <= 128) return launch_tma<128, 2, 3>(p, b, h, kvh, stream);
  return launch_tma<256, 1, 2>(p, b, h, kvh, stream);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// o = attention(q, k, v) on `stream`.  q and o are (B,Sq,H,D), k and v
// (B,Skv,KV,D), all fp32 (bf16 == 0) or all bf16 (bf16 == 1), unit stride
// in D.  `strides` holds 12 element strides: (batch, sequence, head) of q,
// k, v and o in that order.  For bf16, D and every stride must be multiples
// of 8 and every pointer 16-byte aligned.  window == 0 means no sliding
// window.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bf16,
                                   int64_t b, int64_t sq, int64_t skv,
                                   int64_t h, int64_t kvh, int64_t d,
                                   const int64_t* strides, int causal,
                                   int64_t window, float scale,
                                   void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return static_cast<int>(cudaSuccess);
  if (kvh <= 0 || h % kvh != 0 || d < 1 || d > 256 || skv < 0 ||
      window < 0 || b > 65535 || h > 65535 ||
      (sq + kBlockQ - 1) / kBlockQ > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) {
    bool ok = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
              aligned16(o);
    for (int i = 0; i < 12; ++i) ok = ok && strides[i] % 8 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sq = sq;
  p.skv = skv;
  p.group = h / kvh;
  p.d = d;
  p.h = h;
  p.nq = 0;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_tma(p, b, h, kvh, st) : dispatch_simt(p, b, h, st);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
