// Mamba-2 SSD intra-chunk forward for Hopper (sm_90a), with a plain C
// interface (loaded with ctypes by repro_torch/kernels/ssd_scan.py).
//
// Replaces the Pallas kernel ssd_intra_chunk_fwd (_ssd_kernel) of
// src/repro/kernels/ssd_scan.py.  Per (batch, chunk, head), with
// cum = cumsum(dA) over the chunk's Q positions:
//   y[i]  = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j   (Q,P)
//   state = sum_q B_q^T (exp(cum_end - cum_q) * dt_q * x_q)            (P,N)
// over xc (B,NC,Q,H,P) in bf16 or fp32, dt and dA (B,NC,Q,H) fp32 and B, C
// (B,NC,Q,N) fp32, shared by the heads.  Both outputs are fp32; the
// tolerance against the plain version is 1e-4 (the reference's,
// tests/test_kernels.py:51-68).  A call is one launch of one kernel: the
// tensor-core kernel ssd_fwd for bf16 x (the model's prefill), the CUDA-core
// kernel ssd_fwd_simt for fp32 x.
//
// Bound: bytes.  At the prefill shape, B 4 x S 2048 -> (4, 8, 256, 48, 64)
// with N 128, the function needs 1.318e10 FLOP over the causal pairs, of
// which C.B^T, once per batch-chunk, is 2.69e8 and the per-head products
// 1.291e10, against 212.9 MB (chip_smoke.py::ssd_work).  On the tensor
// cores with operands split hi + lo, C.B^T takes three TF32 products and
// W.X and the state product two (bf16 x is exact in TF32): 2.66e10 FLOP at
// 495 TFLOP/s, 0.0538 ms, under the bytes' 0.0635 ms at 3.35 TB/s (fp32 on
// the CUDA cores: 0.197 ms at 67 TFLOP/s).
//
// Precision.  A single TF32 product (10-bit mantissa) misses the 1e-4 by far;
// 3xTF32 holds it (tests/test_torch_ssd_scan.py models both on the CPU against
// the Pallas kernel).  Every fp32 operand a is split as hi = tf32(a) rounded to
// nearest (cvt.rna's arithmetic, not the tensor core's truncation of the low
// bits) and lo = tf32(a - hi), and a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b,
// accumulated in fp32; bf16 x is exact in TF32, so its products take two terms.
// The tensor cores' fp32 sums truncate: summed straight into one fragment over
// N = 128, C.B^T brought the prefill shape to the edge of the tolerance on an
// H100, so each 8-wide step is summed in a fresh fragment and added in fp32
// (0.37 of the tolerance there).  The prefix sums accumulate in double and are
// rounded once to float, as the plain version's cumsum64 (PyTorch's CPU cumsum)
// rounds them: an fp32 sum adds up to half an ulp of the running sum per term
// (the ulp of 200 is 1.5e-5), and exp(cum_i - cum_j) carries that into y at the
// order of the tolerance.  Masking: above the diagonal exp(cum_i - cum_j)
// overflows at full width (|cum| reaches 100s), and inf * 0 is NaN, so the
// weight is selected before it meets the score.
//
// Why fp32 x takes the CUDA cores: 3xTF32 holds the kernel's 1e-4, but an
// fp32 forward of Mamba-2 780M's 48 random layers through it read 1.36e-4
// against the plain path on an H100, past chip_smoke.py's 1e-4 end-to-end
// gate: the layers amplify any rounding other than the plain path's.
// ssd_fwd_simt sums in the plain path's order and matches it bit for bit
// (section at the end).  So two bodies ship, chosen by the dtype of x; the
// model's prefill runs bf16 x and only ssd_fwd.  Setting that gate from
// readings of sound and single-TF32 kernels would let fp32 x run ssd_fwd
// with three products for x, and ssd_fwd_simt go.
//
// Design of ssd_fwd: a grid of work items of two kinds, 128 threads (4
// warps) each, the state items first, then the y items of the row tiles
// with the most column tiles (the block scheduler hands them out in order,
// so the light ones fill the tail; on an H100 this order timed no slower
// than the y items first or an order by cost):
//
// * y items (batch-chunk, 64-row tile i0, group of up to 12 heads).  The
//   48 heads share B and C, so an item computes each causal 64 x 64 score
//   tile S = C_i.B_j^T once, from a 2-stage cp.async ring of 32-wide
//   slices of C and B, and keeps it in shared memory, each lane its own
//   mma fragments (64 KB at Q 256).  It then sweeps its heads: for each
//   column tile, W = S (.) exp(cum_i - cum_j) (.) dt_j is formed in
//   registers straight from those fragments (the k order of the W.X
//   product is permuted so that the accumulator layout of S is the operand
//   layout of W: no shuffles) and y_h += W.X_h on the tensor cores, X_h's
//   bf16 tile (64 x P) staged by cp.async one step ahead and read with
//   ldmatrix.trans.  Only the diagonal and ragged tiles are masked, and
//   the diagonal tile skips the k-steps above each warp's rows.  Why
//   groups of 12: at the prefill shape all 48 heads in one item make 128 y
//   items, under one wave of 132 SMs with the causal tiles 1:4 uneven; 12
//   heads compute S 4 times rather than 48 over 512 items (groups of 8,
//   which recompute S more often, and of 16, with fewer items and more
//   shared memory, both timed slower on an H100).  Each item scans the
//   prefix sums of its heads once (one warp per head, in double).
// * state items (batch-chunk, 64 state dims, 8 heads): the (P,N) states
//   as st^T = (w (.) B)^T X over the chunk in 64-position steps, w_q =
//   exp(cum_end - cum_q) dt_q, the (Q, 64) slice of B held in shared
//   memory for all 8 heads; each warp owns 16 state dims, so the weighted
//   B operand is formed and split once, in registers.
//
// The items write disjoint outputs and sum in a fixed order: no atomics,
// two calls give the same bits.  P (1..128) is padded to 32, 64 or 128
// with zeros, Q (1..256) and N are ragged and masked; unaligned inputs are
// staged by plain loads instead of cp.async.  mma.sync m16n8k8 is the
// simple first form on the tensor cores; wgmma reaches their full rate,
// but takes tf32 operands only K-major from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxQ = 256;
constexpr int kTile = 64;       // rows of y per item; positions per step
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 12;   // heads per y item
constexpr int kStateHeads = 8;  // heads per state item
constexpr int kStateDims = 16 * kWarps;  // state dims per state item
constexpr int kBS = kStateDims + 4;      // row stride of its B slice
constexpr int kNSlice = 32;     // state dims per stage of C.B^T
constexpr int kNStride = 40;    // their row stride (bank offsets)
constexpr int kSliceFloats = 2 * kTile * kNStride;  // a C and a B slice
constexpr int kSFloats = kWarps * 8 * 32 * 4;      // S fragments of a tile

struct Params {
  const void* x;
  const float* dt;
  const float* da;
  const float* b;
  const float* c;
  float* y;
  float* st;
  int64_t bnc, n;
  int q, h, p;
  int group, n_groups, row_tiles, state_groups, n_blocks;
  int64_t y_items, state_items;
  int vec_x, vec_bc;   // 16-byte aligned rows: stage with cp.async
};

// ---------------------------------------------------------------- layout
template <int PP>
struct XTile {   // a 64 x PP tile of bf16 x: rows of PP + 8 (ldmatrix rows)
  static constexpr int kStride = PP + 8;
  static constexpr int kFloats = kTile * kStride / 2;
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// y item: S fragments, then either the C.B^T ring (2 stages) or the x
// ring (2 stages) and the (cum, dt) pairs of the heads; state item: the B
// slice, the x ring, the (cum, dt) pairs and the weights w of the heads
template <int PP>
__host__ __device__ constexpr int smem_floats(int row_tiles, int group) {
  return cmax(row_tiles * kSFloats +
                  cmax(2 * kSliceFloats, 2 * XTile<PP>::kFloats +
                                             group * row_tiles * kTile * 2),
              row_tiles * kTile * kBS + 2 * XTile<PP>::kFloats +
                  3 * kStateHeads * row_tiles * kTile);
}

// ------------------------------------------------------------- primitives
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a rounded to TF32 to nearest, ties away from zero: what cvt.rna.tf32.f32
// computes for a finite a (ptxas expands that instruction into this add
// and mask behind a test for inf and NaN, which the operands here never are)
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a.b, m16n8k8, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// ---------------------------------------------------------------- staging
// ROWS x COLS fp32 tile into dst (row stride ds) from src (row stride ss),
// rows >= rv and columns >= cv read as zeros.  vec: 16-byte cp.async
// (cv a multiple of 4, rows 16-byte aligned); else plain loads.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_f32(float* dst, int ds,
                                          const float* src, int64_t ss,
                                          int rv, int cv, bool vec) {
  if (vec) {
    constexpr int kC = COLS / 4;
    for (int e = threadIdx.x; e < ROWS * kC; e += kThreads) {
      const int r = e / kC, col = (e % kC) * 4;
      const bool ok = r < rv && col < cv;
      cp_async16(dst + r * ds + col, ok ? src + r * ss + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kThreads) {
      const int r = e / COLS, col = e % COLS;
      dst[r * ds + col] = (r < rv && col < cv) ? src[r * ss + col] : 0.f;
    }
  }
}

// a 64 x PP tile of bf16 x, rows >= rv and columns >= P zero
template <int PP>
__device__ __forceinline__ void stage_x(float* dst, const bf16* src,
                                        int64_t ss, int rv, int P, bool vec) {
  constexpr int kS = XTile<PP>::kStride;
  bf16* d = reinterpret_cast<bf16*>(dst);
  if (vec) {
    constexpr int kC = PP / 8;
    for (int e = threadIdx.x; e < kTile * kC; e += kThreads) {
      const int r = e / kC, col = (e % kC) * 8;
      const bool ok = r < rv && col < P;
      cp_async16(d + r * kS + col, ok ? src + r * ss + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * PP; e += kThreads) {
      const int r = e / PP, col = e % PP;
      d[r * kS + col] =
          (r < rv && col < P) ? src[r * ss + col] : __float2bfloat16(0.f);
    }
  }
}

// ------------------------------------------------------------ prefix sums
// cd[i] = (cum_i, dt_i) for i < qn, zeros for qn <= i < qpad, from one
// head's (Q,) columns of dA and dt (element stride `stride`); one warp.
// Each lane sums 8 consecutive values in double, the lane totals are
// scanned with shuffles, and each sum is rounded once to float.
__device__ void scan_head(const float* da, const float* dt, int64_t stride,
                          int qn, int qpad, float2* cd, int lane) {
  constexpr int kPer = kMaxQ / 32;
  double part[kPer];
  float dts[kPer];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = lane * kPer + k;
    float a = 0.f, d = 0.f;
    if (i < qn) {
      a = da[i * stride];
      d = dt[i * stride];
    }
    run += static_cast<double>(a);
    part[k] = run;
    dts[k] = d;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += t;
  }
  const double before = tot - run;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = lane * kPer + k;
    if (i < qpad) {
      cd[i] = i < qn ? make_float2(static_cast<float>(before + part[k]),
                                   dts[k])
                     : make_float2(0.f, 0.f);
    }
  }
}

// ----------------------------------------------------- products with x
// acc[nt] += A . X[rows 8kk..8kk+7 of the tile] for every 8-column n-tile
// of X (bf16 pairs from ldmatrix.trans, widened by shifts: exact in TF32),
// in the permuted k order: A's k = t and t + 4 are the tile's positions
// 8kk + 2t and 8kk + 2t + 1 (ah, al: hi and lo of A).
template <int PP>
__device__ __forceinline__ void mma_x(float (&acc)[PP / 8][4],
                                      const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4],
                                      const bf16* xs, int kk, int lane) {
  constexpr int kS = XTile<PP>::kStride;
#pragma unroll
  for (int m4 = 0; m4 < PP / 32; ++m4) {
    uint32_t r[4];
    ldsm_x4_trans(r, xs + (8 * kk + (lane & 7)) * kS +
                         8 * (4 * m4 + (lane >> 3)));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b0 = r[i] << 16, b1 = r[i] & 0xffff0000u;
      mma(acc[4 * m4 + i], al, b0, b1);
      mma(acc[4 * m4 + i], ah, b0, b1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// exp(x) as ex2.approx.ftz(x log2(e)): within about 2^-21 of expf where
// the decay matters (|x| < 20); results below 2^-126 flush to zero
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.44269504f));
  return y;
}

// the weight of score s at (row i, column j), selected before the exp
__device__ __forceinline__ float weight(float s, float cum_i, float2 cdj,
                                        bool ok) {
  const float e = ok ? exp_approx(cum_i - cdj.x) : 0.f;
  return s * e * cdj.y;
}

// y rows (i_a, i_b = i_a + 8) += W . X_h over one 64-column tile at j0,
// k-steps 0..ksteps-1, W formed from the tile's S fragments sf (this
// lane's, one per k-step) and the head's (cum, dt) pairs cd.  EDGE: the
// diagonal tile or a ragged one, whose weights are masked.
template <bool EDGE, int PP>
__device__ __forceinline__ void y_tile(float (&acc)[PP / 8][4],
                                       const float4* sf, const float2* cd,
                                       const bf16* xs, float cum_a, float cum_b,
                                       int i_a, int j0, int q, int ksteps,
                                       int lane) {
  const int tq = lane & 3, i_b = i_a + 8;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (EDGE && kk >= ksteps) break;
    const float4 sv = sf[kk * 32];
    const int j = j0 + 8 * kk + 2 * tq;
    const float4 c2 = *reinterpret_cast<const float4*>(cd + j);
    const float2 cj0 = make_float2(c2.x, c2.y), cj1 = make_float2(c2.z, c2.w);
    const bool a0 = !EDGE || (i_a < q && j <= i_a && j < q);
    const bool b0 = !EDGE || (i_b < q && j <= i_b && j < q);
    const bool a1 = !EDGE || (i_a < q && j + 1 <= i_a && j + 1 < q);
    const bool b1 = !EDGE || (i_b < q && j + 1 <= i_b && j + 1 < q);
    uint32_t ah[4], al[4];
    split(weight(sv.x, cum_a, cj0, a0), ah[0], al[0]);
    split(weight(sv.z, cum_b, cj0, b0), ah[1], al[1]);
    split(weight(sv.y, cum_a, cj1, a1), ah[2], al[2]);
    split(weight(sv.w, cum_b, cj1, b1), ah[3], al[3]);
    mma_x<PP>(acc, ah, al, xs, kk, lane);
  }
}

// ------------------------------------------------------------------ y item
template <int PP>
__device__ void y_item(const Params& p, int64_t item, float* smem) {
  constexpr int NT = PP / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q = p.q, H = p.h, P = p.p;
  const int64_t N = p.n;
  const int64_t per_tile = p.bnc * p.n_groups;
  const int t = p.row_tiles - 1 - static_cast<int>(item / per_tile);
  const int64_t bc = (item % per_tile) / p.n_groups;
  const int h0 = static_cast<int>(item % p.n_groups) * p.group;
  const int nh = min(p.group, H - h0);
  const int i0 = t * kTile, qpad = i0 + kTile, qn = min(q, qpad);
  const int qall = p.row_tiles * kTile;
  const bool live = i0 + 16 * warp < q;   // the warp has rows to compute

  float4* s_frag = reinterpret_cast<float4*>(smem);
  float* stage = smem + p.row_tiles * kSFloats;
  float2* cd = reinterpret_cast<float2*>(stage + 2 * XTile<PP>::kFloats);
  const float* cg = p.c + bc * q * N;
  const float* bg = p.b + bc * q * N;

  // --- S = C_i . B_j^T for the column tiles 0..t, over N in 32-wide
  // slices, each 8-wide step of the split products summed in a fresh
  // fragment: the tensor cores' fp32 sums lose low bits to truncation, and
  // fewer of them into the large S keep it within the tolerance
  const int slices = static_cast<int>((N + kNSlice - 1) / kNSlice);
  const int steps1 = (t + 1) * slices;
  auto issue1 = [&](int s) {
    if (s < steps1) {
      const int jt = s / slices;
      const int64_t n0 = static_cast<int64_t>(s % slices) * kNSlice;
      const int cv = static_cast<int>(N - n0 < kNSlice ? N - n0 : kNSlice);
      float* buf = stage + (s & 1) * kSliceFloats;
      stage_f32<kTile, kNSlice>(buf, kNStride, cg + i0 * N + n0, N, q - i0,
                                cv, p.vec_bc);
      stage_f32<kTile, kNSlice>(buf + kTile * kNStride, kNStride,
                                bg + jt * kTile * N + n0, N, q - jt * kTile,
                                cv, p.vec_bc);
    }
    cp_async_commit();
  };
  issue1(0);
  float sacc[8][4];
  zero(sacc);
  for (int s = 0; s < steps1; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    issue1(s + 1);
    const int jt = s / slices;
    // n-tiles (8 columns) of this tile at or below the warp's diagonal
    const int ntiles = jt == t ? 2 * warp + 2 : 8;
    if (!live) continue;
    const float* cs = stage + (s & 1) * kSliceFloats;
    const float* bs = cs + kTile * kNStride;
#pragma unroll
    for (int kq = 0; kq < kNSlice / 8; ++kq) {
      const float2 c0 = *reinterpret_cast<const float2*>(
          cs + (16 * warp + g) * kNStride + 8 * kq + 2 * tq);
      const float2 c1 = *reinterpret_cast<const float2*>(
          cs + (16 * warp + g + 8) * kNStride + 8 * kq + 2 * tq);
      uint32_t ah[4], al[4];
      split(c0.x, ah[0], al[0]);
      split(c1.x, ah[1], al[1]);
      split(c0.y, ah[2], al[2]);
      split(c1.y, ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < ntiles) {
          const float2 bv = *reinterpret_cast<const float2*>(
              bs + (8 * nt + g) * kNStride + 8 * kq + 2 * tq);
          uint32_t h0b, l0b, h1b, l1b;
          split(bv.x, h0b, l0b);
          split(bv.y, h1b, l1b);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma(part, al, h0b, h1b);
          mma(part, ah, l0b, l1b);
          mma(part, ah, h0b, h1b);
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[nt][e] += part[e];
        }
      }
    }
    if (s % slices == slices - 1) {   // the tile's S is complete
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < ntiles) {
          s_frag[((jt * kWarps + warp) * 8 + nt) * 32 + lane] = make_float4(
              sacc[nt][0], sacc[nt][1], sacc[nt][2], sacc[nt][3]);
        }
      }
      zero(sacc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for x and the prefix sums

  // --- per head: y_h = sum over column tiles of W . X_h
  const bf16* xg = static_cast<const bf16*>(p.x) + bc * q * H * P;
  const int steps2 = nh * (t + 1);
  auto issue2 = [&](int s) {
    if (s < steps2) {
      const int k = s / (t + 1), jt = s % (t + 1);
      stage_x<PP>(stage + (s & 1) * XTile<PP>::kFloats,
                  xg + static_cast<int64_t>(jt) * kTile * H * P +
                      static_cast<int64_t>(h0 + k) * P,
                  static_cast<int64_t>(H) * P, q - jt * kTile, P, p.vec_x);
    }
    cp_async_commit();
  };
  issue2(0);
  for (int k = warp; k < nh; k += kWarps) {
    const int64_t off = bc * q * H + h0 + k;
    scan_head(p.da + off, p.dt + off, H, qn, qpad, cd + k * qall, lane);
  }
  const int r0 = 16 * warp + g;   // the lane's rows i0 + r0, i0 + r0 + 8
  const int i_a = i0 + r0, i_b = i_a + 8;
  float acc[NT][4];
  zero(acc);
  float cum_a = 0.f, cum_b = 0.f;
  for (int s = 0; s < steps2; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    issue2(s + 1);
    const int k = s / (t + 1), jt = s % (t + 1);
    if (!live) continue;
    const float2* cdk = cd + k * qall;
    if (jt == 0) {
      cum_a = cdk[i_a].x;
      cum_b = cdk[i_b].x;
    }
    const bf16* xs = reinterpret_cast<const bf16*>(
        stage + (s & 1) * XTile<PP>::kFloats);
    const float4* sf = s_frag + (jt * kWarps + warp) * 8 * 32 + lane;
    if (jt == t || i0 + kTile > q) {
      y_tile<true, PP>(acc, sf, cdk, xs, cum_a, cum_b, i_a, jt * kTile, q,
                          jt == t ? 2 * warp + 2 : 8, lane);
    } else {
      y_tile<false, PP>(acc, sf, cdk, xs, cum_a, cum_b, i_a, jt * kTile,
                           q, 8, lane);
    }
    if (jt == t) {   // head h0 + k is complete
      float* ya = p.y + ((bc * q + i_a) * H + h0 + k) * static_cast<int64_t>(P);
      float* yb = ya + static_cast<int64_t>(8) * H * P;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * tq;
        if (i_a < q) {
          if (col < P) ya[col] = acc[nt][0];
          if (col + 1 < P) ya[col + 1] = acc[nt][1];
        }
        if (i_b < q) {
          if (col < P) yb[col] = acc[nt][2];
          if (col + 1 < P) yb[col + 1] = acc[nt][3];
        }
      }
      zero(acc);
    }
  }
}

// -------------------------------------------------------------- state item
// The states of up to 8 heads of one batch-chunk over 64 state dims: the
// (Q, 64) slice of B stays in shared memory for all of them (its 64 KB
// would otherwise stream from L2 again for every head), X_h streams in
// 64-position tiles, and st_h^T = (w_h (.) B)^T X_h with each warp owning
// 16 state dims, so the weighted B operand is formed and split once.
template <int PP>
__device__ void state_item(const Params& p, int64_t item, float* smem) {
  constexpr int NT = PP / 8;
  constexpr int XF = XTile<PP>::kFloats;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q = p.q, H = p.h, P = p.p;
  const int64_t N = p.n;
  const int64_t bc = item / (p.n_blocks * p.state_groups);
  const int64_t rest = item % (p.n_blocks * p.state_groups);
  const int64_t n0 = (rest / p.state_groups) * kStateDims;
  const int h0 = static_cast<int>(rest % p.state_groups) * kStateHeads;
  const int nh = min(kStateHeads, H - h0);
  const int qall = p.row_tiles * kTile;

  float* bres = smem;
  float* xring = bres + qall * kBS;
  float2* cd = reinterpret_cast<float2*>(xring + 2 * XF);
  float* wq = reinterpret_cast<float*>(cd + kStateHeads * qall);
  const bf16* xg = static_cast<const bf16*>(p.x) + bc * q * H * P +
                   static_cast<int64_t>(h0) * P;
  const float* bg = p.b + bc * q * N + n0;
  const int nv = static_cast<int>(N - n0 < kStateDims ? N - n0 : kStateDims);

  // B's slice goes with the first x tile; then one step per (head, tile)
  for (int qt = 0; qt < p.row_tiles; ++qt) {
    stage_f32<kTile, kStateDims>(bres + qt * kTile * kBS, kBS,
                                 bg + qt * kTile * N, N, q - qt * kTile, nv,
                                 p.vec_bc);
  }
  const int steps = nh * p.row_tiles;
  auto issue = [&](int s) {
    if (s < steps) {
      const int k = s / p.row_tiles, qt = s % p.row_tiles;
      stage_x<PP>(xring + (s & 1) * XF,
                  xg + static_cast<int64_t>(qt) * kTile * H * P +
                      static_cast<int64_t>(k) * P,
                  static_cast<int64_t>(H) * P, q - qt * kTile, P, p.vec_x);
    }
    cp_async_commit();
  };
  issue(0);
  for (int k = warp; k < nh; k += kWarps) {
    const int64_t off = bc * q * H + h0 + k;
    scan_head(p.da + off, p.dt + off, H, q, qall, cd + k * qall, lane);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nh * qall; e += kThreads) {
    // w_q = exp(cum_end - cum_q) dt_q; cum_end <= cum_q where dA <= 0
    const float2* c = cd + (e / qall) * qall;
    const int i = e % qall;
    wq[e] = i < q ? expf(c[q - 1].x - c[i].x) * c[i].y : 0.f;
  }

  float acc[NT][4];
  zero(acc);
  const int nl = 16 * warp + g;   // the lane's state dims nl, nl + 8
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();   // also publishes wq
    issue(s + 1);
    const int k = s / p.row_tiles, qt = s % p.row_tiles;
    if (16 * warp < nv) {
      const bf16* xs = reinterpret_cast<const bf16*>(xring + (s & 1) * XF);
      const float* wk = wq + k * qall + qt * kTile;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int ql = 8 * kk + 2 * tq;
        const float w0 = wk[ql], w1 = wk[ql + 1];
        const float* b0 = bres + (qt * kTile + ql) * kBS + nl;
        uint32_t ah[4], al[4];
        split(w0 * b0[0], ah[0], al[0]);
        split(w0 * b0[8], ah[1], al[1]);
        split(w1 * b0[kBS], ah[2], al[2]);
        split(w1 * b0[kBS + 8], ah[3], al[3]);
        mma_x<PP>(acc, ah, al, xs, kk, lane);
      }
    }
    if (qt == p.row_tiles - 1) {   // head h0 + k is complete
      float* sg = p.st + (bc * H + h0 + k) * static_cast<int64_t>(P) * N;
      const int64_t na = n0 + nl, nb = na + 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + 2 * tq;
        if (col < P) {
          if (nl < nv) sg[col * N + na] = acc[nt][0];
          if (nl + 8 < nv) sg[col * N + nb] = acc[nt][2];
        }
        if (col + 1 < P) {
          if (nl < nv) sg[(col + 1) * N + na] = acc[nt][1];
          if (nl + 8 < nv) sg[(col + 1) * N + nb] = acc[nt][3];
        }
      }
      zero(acc);
    }
  }
}

// one block per work item: the state items, then the y items, the row
// tiles with the most column tiles first
template <int PP>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_fwd(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const int64_t item = blockIdx.x;
  if (item < p.state_items) {
    state_item<PP>(p, item, smem);
  } else {
    y_item<PP>(p, item - p.state_items, smem);
  }
}

template <int PP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes =
      static_cast<size_t>(smem_floats<PP>(p.row_tiles, p.group)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_fwd<PP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int64_t items = p.y_items + p.state_items;
  ssd_fwd<PP><<<static_cast<unsigned>(items), kThreads, bytes, stream>>>(
      p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.p <= 32) return launch<32>(p, stream);
  if (p.p <= 64) return launch<64>(p, stream);
  return launch<128>(p, stream);
}

// ------------------------------------------------ fp32 x: the CUDA cores
// The arithmetic of the plain path's fp32 products, in their order: each
// score a sequential fp32 sum over N, each weight (s * decay) * dt, each y
// and state element a sequential fp32 sum over the positions.  The plain
// chunked path computes the same bits with cuBLAS, so an fp32 forward
// through this body matches it exactly (the 1e-4 end-to-end gate of
// chip_smoke.py over 48 random layers amplifies any other rounding past
// it).  One block per (64-row tile, head, batch-chunk) or (head,
// batch-chunk) state, 256 threads as a 16 x 16 grid: thread (ty, tx) owns
// rows 4ty..4ty+3 and columns tx + 16k, shared-memory rows padded by one
// word; C.B^T is computed per head.
namespace simt {

constexpr int kThreads = 256;
constexpr int kRows = 4;        // rows of a tile per thread
constexpr int kStepN = 32;      // state dims per step of C.B^T
constexpr int kStepQ = 32;      // positions per step of the state product
constexpr int kStateCols = 64;  // state dims per pass of the state

// cd[i] = (cum_i, dt_i) for i < q (scan_head, warp 0); ends in a barrier
__device__ void load_cum(const Params& p, int64_t hh, int64_t bc,
                         float2* cd) {
  if (threadIdx.x < 32) {
    const int64_t off = bc * p.q * p.h + hh;
    scan_head(p.da + off, p.dt + off, p.h, p.q, p.q, cd, threadIdx.x);
  }
  __syncthreads();
}

template <int PP>
constexpr int y_floats() {
  return 2 * kMaxQ + 2 * kTile * (kStepN + 1) + kTile * (kTile + 4) +
         kTile * PP;
}

template <int PP>
constexpr int state_floats() {
  return 3 * kMaxQ + kStepQ * PP + kStepQ * kStateCols;
}

// y rows i0..i0+63 of one (batch-chunk, head)
template <int PP>
__device__ void y_block(const Params& p, int i0, int64_t hh, int64_t bc,
                        float* smem) {
  constexpr int CO = PP / 16;                 // output columns per thread
  constexpr int KS = kStepN + 1, WS = kTile + 4;  // padded row strides
  float2* cd = reinterpret_cast<float2*>(smem);   // (cum, dt)
  float* cs = smem + 2 * kMaxQ;
  float* bs = cs + kTile * KS;
  float* ws = bs + kTile * KS;
  float* xs = ws + kTile * WS;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q = p.q;
  const int64_t H = p.h, P = p.p, N = p.n;
  const float* xg = static_cast<const float*>(p.x) + bc * q * H * P + hh * P;
  const float* bg = p.b + bc * q * N;
  const float* cg = p.c + bc * q * N;
  float* yg = p.y + bc * q * H * P + hh * P;
  load_cum(p, hh, bc, cd);

  float acc[kRows][CO];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[r][k] = 0.f;
  }

  for (int j0 = 0; j0 <= i0; j0 += kTile) {
    float sc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[r][k] = 0.f;
    }
    for (int64_t n0 = 0; n0 < N; n0 += kStepN) {
      __syncthreads();  // the last step's tiles are consumed
      for (int e = tid; e < kTile * kStepN; e += kThreads) {
        const int r = e / kStepN, k = e % kStepN;
        const int64_t nn = n0 + k;
        const int ci = i0 + r, bj = j0 + r;
        cs[r * KS + k] = (ci < q && nn < N) ? cg[ci * N + nn] : 0.f;
        bs[r * KS + k] = (bj < q && nn < N) ? bg[bj * N + nn] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kStepN; ++k) {
        float a[kRows], bv[4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = cs[(ty * kRows + r) * KS + k];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = bs[(tx + 16 * jj) * KS + k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            sc[r][jj] = fmaf(a[r], bv[jj], sc[r][jj]);
          }
        }
      }
    }
    // weights (C_i.B_j) * L[i,j] * dt_j, selected before the exp
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + ty * kRows + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + tx + 16 * jj;
        float w = 0.f;
        if (j <= i && i < q) {
          w = sc[r][jj] * expf(cd[i].x - cd[j].x) * cd[j].y;
        }
        ws[(ty * kRows + r) * WS + tx + 16 * jj] = w;
      }
    }
    for (int e = tid; e < kTile * PP; e += kThreads) {
      const int r = e / PP, col = e % PP;
      const int j = j0 + r;
      xs[e] = (j < q && col < P) ? xg[j * H * P + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float wr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) wr[r] = ws[(ty * kRows + r) * WS + j];
#pragma unroll
      for (int k = 0; k < CO; ++k) {
        const float xv = xs[j * PP + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][k] = fmaf(wr[r], xv, acc[r][k]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + ty * kRows + r;
    if (i >= q) continue;
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const int col = tx + 16 * k;
      if (col < P) yg[i * H * P + col] = acc[r][k];
    }
  }
}

// the (P,N) chunk state of one (batch-chunk, head), N in passes of 64
// columns, Q in steps of 32 positions
template <int PP>
__device__ void state_block(const Params& p, int64_t hh, int64_t bc,
                            float* smem) {
  constexpr int RO = PP / 16;                 // state rows (p) per thread
  constexpr int CO = kStateCols / 16;         // state columns (n) per thread
  float2* cd = reinterpret_cast<float2*>(smem);   // (cum, dt)
  float* wq = smem + 2 * kMaxQ;
  float* xw = wq + kMaxQ;
  float* bq = xw + kStepQ * PP;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q = p.q;
  const int64_t H = p.h, P = p.p, N = p.n;
  const float* xg = static_cast<const float*>(p.x) + bc * q * H * P + hh * P;
  const float* bg = p.b + bc * q * N;
  float* sg = p.st + (bc * H + hh) * P * N;
  load_cum(p, hh, bc, cd);
  const float cend = cd[q - 1].x;
  for (int i = tid; i < q; i += kThreads) {
    wq[i] = expf(cend - cd[i].x) * cd[i].y;   // cend <= cum_i: no overflow
  }

  for (int64_t n0 = 0; n0 < N; n0 += kStateCols) {
    float acc[RO][CO];
#pragma unroll
    for (int r = 0; r < RO; ++r) {
#pragma unroll
      for (int k = 0; k < CO; ++k) acc[r][k] = 0.f;
    }
    for (int q0 = 0; q0 < q; q0 += kStepQ) {
      __syncthreads();  // wq is written; the last step's tiles are consumed
      for (int e = tid; e < kStepQ * PP; e += kThreads) {
        const int r = e / PP, col = e % PP;
        const int i = q0 + r;
        xw[e] = (i < q && col < P) ? xg[i * H * P + col] * wq[i] : 0.f;
      }
      for (int e = tid; e < kStepQ * kStateCols; e += kThreads) {
        const int r = e / kStateCols, k = e % kStateCols;
        const int i = q0 + r;
        const int64_t nn = n0 + k;
        bq[e] = (i < q && nn < N) ? bg[i * N + nn] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < kStepQ; ++i) {
        float xv[RO];
#pragma unroll
        for (int r = 0; r < RO; ++r) xv[r] = xw[i * PP + ty * RO + r];
#pragma unroll
        for (int k = 0; k < CO; ++k) {
          const float bv = bq[i * kStateCols + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < RO; ++r) acc[r][k] = fmaf(xv[r], bv, acc[r][k]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const int64_t row = ty * RO + r;
      if (row >= P) continue;
#pragma unroll
      for (int k = 0; k < CO; ++k) {
        const int64_t nn = n0 + tx + 16 * k;
        if (nn < N) sg[row * N + nn] = acc[r][k];
      }
    }
  }
}

// one block per y tile (heaviest first), then one per state
template <int PP>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd_simt(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  const int64_t per_tile = p.bnc * p.h;
  const int64_t item = blockIdx.x;
  const int64_t r = item % per_tile;
  if (item < p.row_tiles * per_tile) {
    const int t = p.row_tiles - 1 - static_cast<int>(item / per_tile);
    y_block<PP>(p, t * kTile, r % p.h, r / p.h, smem);
  } else {
    state_block<PP>(p, r % p.h, r / p.h, smem);
  }
}

template <int PP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(cmax(y_floats<PP>(),
                                                state_floats<PP>())) *
                       sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_simt<PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int64_t items = (p.row_tiles + 1) * p.bnc * p.h;
  ssd_fwd_simt<PP><<<static_cast<unsigned>(items), kThreads, bytes,
                     stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.p <= 16) return simt::launch<16>(p, stream);
  if (p.p <= 32) return simt::launch<32>(p, stream);
  if (p.p <= 64) return simt::launch<64>(p, stream);
  return simt::launch<128>(p, stream);
}

}  // namespace simt

}  // namespace

// y (B,NC,Q,H,P) and st (B,NC,H,P,N), both fp32, from x (B,NC,Q,H,P) fp32
// (bf16 == 0) or bf16 (bf16 == 1), dt and da (B,NC,Q,H) fp32, b and c
// (B,NC,Q,N) fp32, all contiguous, on `stream`; bnc = B * NC.  Takes
// 1 <= Q <= 256 and 1 <= P <= 128.  One kernel launch; returns its
// cudaError_t.
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dt,
                                   const void* da, const void* b,
                                   const void* c, void* y, void* st,
                                   int x_bf16,
                                   int64_t bnc, int64_t q, int64_t h,
                                   int64_t p, int64_t n, void* stream) {
  if (bnc == 0 || h == 0) return static_cast<int>(cudaSuccess);
  if (bnc < 0 || h < 0 || h > 65535 || q < 1 || q > kMaxQ || p < 1 ||
      p > 128 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  prm.x = x;
  prm.dt = static_cast<const float*>(dt);
  prm.da = static_cast<const float*>(da);
  prm.b = static_cast<const float*>(b);
  prm.c = static_cast<const float*>(c);
  prm.y = static_cast<float*>(y);
  prm.st = static_cast<float*>(st);
  prm.bnc = bnc;
  prm.n = n;
  prm.q = static_cast<int>(q);
  prm.h = static_cast<int>(h);
  prm.p = static_cast<int>(p);
  prm.n_groups = static_cast<int>((h + kMaxGroup - 1) / kMaxGroup);
  prm.group = static_cast<int>((h + prm.n_groups - 1) / prm.n_groups);
  prm.row_tiles = static_cast<int>((q + kTile - 1) / kTile);
  prm.y_items = bnc * prm.row_tiles * prm.n_groups;
  prm.state_groups = static_cast<int>((h + kStateHeads - 1) / kStateHeads);
  prm.n_blocks = static_cast<int>((n + kStateDims - 1) / kStateDims);
  prm.state_items = bnc * prm.n_blocks * prm.state_groups;
  if (prm.y_items + prm.state_items > 0x7fffffffLL ||
      (prm.row_tiles + 1) * bnc * h > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prm.vec_x = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && p % 8 == 0;
  prm.vec_bc = (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
               (reinterpret_cast<uintptr_t>(c) % 16 == 0) && n % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_bf16 ? dispatch(prm, s) : simt::dispatch(prm, s);
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
