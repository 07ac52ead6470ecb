// Mamba-2 SSD intra-chunk forward for Hopper (sm_90a), with a plain C
// interface (loaded with ctypes by repro_torch/kernels/ssd_scan.py).
//
// Replaces the Pallas kernel ssd_intra_chunk_fwd (_ssd_kernel) of
// src/repro/kernels/ssd_scan.py.  Per (batch, chunk, head), with
// cum = cumsum(dA) over the chunk's Q positions:
//   y[i]  = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j   (Q,P)
//   state = sum_q B_q^T (exp(cum_end - cum_q) * dt_q * x_q)            (P,N)
// over xc (B,NC,Q,H,P) in fp32 or bf16 (read as it is, widened on load),
// dt and dA (B,NC,Q,H) fp32 and B, C (B,NC,Q,N) fp32, shared by the heads.
// Both outputs are fp32 with fp32 accumulation; the tolerance against the
// plain version is 1e-4 (the reference's, tests/test_kernels.py:51-68).
//
// The TPU kernel holds one (b, chunk, head) cell's whole (Q,Q) score and
// decay tiles in VMEM: at Q = 256 that is 256 KB of fp32, more than an
// SM's 227 KB of shared memory.  Here the y kernel tiles as a flash kernel
// does without the softmax: one block owns 64 rows of y for one (b, chunk,
// head) and walks the causal column tiles j0 <= i0 of 64, computing each
// 64 x 64 tile of C.B^T over N in steps of 32, weighting it, and
// multiplying it into the (64, P) accumulator held in registers.  The state
// is a second __global__ (one block per (b, chunk, head)), launched behind
// the first by the same call.  Every block recomputes the prefix sum of its
// head's Q values of dA (one warp, shuffle scan in double, rounded once to
// float as the plain version rounds it), which is cheaper than a pass
// through device memory.  C.B^T is recomputed for each head, as the
// Pallas grid does: sharing it across the heads would halve the work and is
// left to the redesign.
//
// Masking: the upper triangle exp(cum_i - cum_j), i < j, is exp of a
// positive number that overflows at full width (|cum| reaches 100s), and
// inf * 0 is NaN, so the weight is selected before the exp is taken.
//
// Bound: operations.  At the prefill shape, B 4 x S 2048 ->
// (4, 8, 256, 48, 64) with N 128, the function needs 1.318e10 FLOP over the
// causal pairs (C.B^T once per (batch, chunk), the rest per head; the
// Pallas grid's full Q x Q tiles per head are 1.986e10) against 212.9 MB:
// 0.197 ms at the 67 TFLOP/s fp32 peak against 0.0635 ms at 3.35 TB/s
// (chip_smoke.py::ssd_work).  This first version runs in fp32 on the CUDA
// cores, as the TPU kernel casts everything to f32; the 1e-4 tolerance
// rules out bf16 tensor cores, and TF32's 10-bit mantissa is marginal for
// it.  A design on the tensor cores (3xTF32 or split bf16, wgmma, TMA) is
// later work.
//
// Design: 256 threads as a 16 x 16 grid.  In the y kernel thread (ty, tx)
// owns rows 4*ty..4*ty+3 of the tile and columns tx + 16*k of the score
// tile and of the output, so the inner loops read shared memory without
// bank conflicts (rows padded by one word) and keep 16 scores and 4*P/16
// outputs in registers.  P is a template parameter padded to 16, 32, 64 or
// 128 with zeros; Q (1..256) and N are ragged and masked.  Row tiles are
// issued heaviest (most column tiles) first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 256;
constexpr int kTile = 64;       // rows of y per block, columns j per step
constexpr int kThreads = 256;   // 16 x 16
constexpr int kRows = 4;        // rows of a tile per thread
constexpr int kStepN = 32;      // state dims per step of C.B^T
constexpr int kStepQ = 32;      // positions per step of the state product
constexpr int kStateCols = 64;  // state dims per pass of the state kernel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Params {
  const void* x;
  const float* dt;
  const float* da;
  const float* b;
  const float* c;
  float* y;
  float* st;
  int64_t q, h, p, n;
};

// cum[i] = da[0] + ... + da[i] and dts[i] = dt[i] for i < q, reading the
// (Q,) column of one head (element stride `stride`).  The sums accumulate in
// double and are rounded once to float, as the plain version's cumsum64
// (PyTorch's CPU cumsum) rounds them: an fp32 accumulation adds up to half
// an ulp of the running sum per term (the ulp of 200 is 1.5e-5), and
// exp(cum_i - cum_j) carries that into y as a relative error of the order
// of the tolerance.  Warp 0 scans: each lane sums 8 consecutive values,
// then the lane totals are scanned with shuffles.  Ends in a barrier.
__device__ void load_cum(const float* da, const float* dt, int64_t stride,
                         int q, float* cum, float* dts) {
  for (int i = threadIdx.x; i < q; i += blockDim.x) dts[i] = dt[i * stride];
  if (threadIdx.x < 32) {
    constexpr int kPer = kMaxQ / 32;
    const int lane = threadIdx.x;
    double part[kPer];
    double run = 0.0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = lane * kPer + k;
      if (i < q) run += static_cast<double>(da[i * stride]);
      part[k] = run;
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
      if (i < q) cum[i] = static_cast<float>(before + part[k]);
    }
  }
  __syncthreads();
}

template <int PP>
constexpr size_t y_smem_floats() {
  return 2 * kMaxQ + 2 * kTile * (kStepN + 1) + kTile * (kTile + 4) +
         kTile * PP;
}

template <int PP>
constexpr size_t state_smem_floats() {
  return 3 * kMaxQ + kStepQ * PP + kStepQ * kStateCols;
}

// grid (row tiles, H, B*NC): y rows i0..i0+63 of one (batch-chunk, head).
template <typename T, int PP>
__global__ void __launch_bounds__(kThreads) ssd_y(Params p) {
  constexpr int CO = PP / 16;                 // output columns per thread
  constexpr int KS = kStepN + 1, WS = kTile + 4;  // padded row strides
  extern __shared__ float smem[];
  float* cum = smem;
  float* dts = cum + kMaxQ;
  float* cs = dts + kMaxQ;
  float* bs = cs + kTile * KS;
  float* ws = bs + kTile * KS;
  float* xs = ws + kTile * WS;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q = static_cast<int>(p.q);
  const int64_t H = p.h, P = p.p, N = p.n;
  const int i0 = static_cast<int>(gridDim.x - 1 - blockIdx.x) * kTile;
  const int64_t hh = blockIdx.y, bc = blockIdx.z;
  const T* xg = static_cast<const T*>(p.x) + bc * p.q * H * P + hh * P;
  const float* bg = p.b + bc * p.q * N;
  const float* cg = p.c + bc * p.q * N;
  float* yg = p.y + bc * p.q * H * P + hh * P;
  load_cum(p.da + bc * p.q * H + hh, p.dt + bc * p.q * H + hh, H, q, cum,
           dts);

  float acc[kRows][CO];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[r][k] = 0.f;
  }

  for (int j0 = 0; j0 <= i0; j0 += kTile) {
    float s[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) s[r][k] = 0.f;
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
          for (int jj = 0; jj < 4; ++jj) s[r][jj] = fmaf(a[r], bv[jj], s[r][jj]);
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
        if (j <= i && i < q) w = s[r][jj] * expf(cum[i] - cum[j]) * dts[j];
        ws[(ty * kRows + r) * WS + tx + 16 * jj] = w;
      }
    }
    for (int e = tid; e < kTile * PP; e += kThreads) {
      const int r = e / PP, col = e % PP;
      const int j = j0 + r;
      xs[e] = (j < q && col < P) ? to_float(xg[j * H * P + col]) : 0.f;
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

// grid (H, B*NC): the (P,N) chunk state of one (batch-chunk, head), N in
// passes of 64 columns, Q in steps of 32 positions.
template <typename T, int PP>
__global__ void __launch_bounds__(kThreads) ssd_state(Params p) {
  constexpr int RO = PP / 16;                 // state rows (p) per thread
  constexpr int CO = kStateCols / 16;         // state columns (n) per thread
  extern __shared__ float smem[];
  float* cum = smem;
  float* dts = cum + kMaxQ;
  float* wq = dts + kMaxQ;
  float* xw = wq + kMaxQ;
  float* bq = xw + kStepQ * PP;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q = static_cast<int>(p.q);
  const int64_t H = p.h, P = p.p, N = p.n;
  const int64_t hh = blockIdx.x, bc = blockIdx.y;
  const T* xg = static_cast<const T*>(p.x) + bc * p.q * H * P + hh * P;
  const float* bg = p.b + bc * p.q * N;
  float* sg = p.st + (bc * H + hh) * P * N;
  load_cum(p.da + bc * p.q * H + hh, p.dt + bc * p.q * H + hh, H, q, cum,
           dts);
  const float cend = cum[q - 1];
  for (int i = tid; i < q; i += kThreads) {
    wq[i] = expf(cend - cum[i]) * dts[i];   // cend <= cum[i]: no overflow
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
        xw[e] = (i < q && col < P) ? to_float(xg[i * H * P + col]) * wq[i]
                                   : 0.f;
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

template <typename T, int PP>
cudaError_t launch(const Params& p, int64_t bnc, cudaStream_t stream) {
  const size_t y_bytes = y_smem_floats<PP>() * sizeof(float);
  const size_t s_bytes = state_smem_floats<PP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y<T, PP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(y_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_state<T, PP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_bytes));
  if (err != cudaSuccess) return err;
  const dim3 ygrid(static_cast<unsigned>((p.q + kTile - 1) / kTile),
                   static_cast<unsigned>(p.h), static_cast<unsigned>(bnc));
  ssd_y<T, PP><<<ygrid, kThreads, y_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sgrid(static_cast<unsigned>(p.h), static_cast<unsigned>(bnc));
  ssd_state<T, PP><<<sgrid, kThreads, s_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int64_t bnc, cudaStream_t stream) {
  if (p.p <= 16) return launch<T, 16>(p, bnc, stream);
  if (p.p <= 32) return launch<T, 32>(p, bnc, stream);
  if (p.p <= 64) return launch<T, 64>(p, bnc, stream);
  return launch<T, 128>(p, bnc, stream);
}

}  // namespace

// y (B,NC,Q,H,P) and st (B,NC,H,P,N), both fp32, from x (B,NC,Q,H,P) fp32
// (bf16 == 0) or bf16 (bf16 == 1), dt and da (B,NC,Q,H) fp32, b and c
// (B,NC,Q,N) fp32, all contiguous, on `stream`; bnc = B * NC.  Takes
// 1 <= Q <= 256 and 1 <= P <= 128.  Returns the cudaError_t of the two
// launches.
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dt,
                                   const void* da, const void* b,
                                   const void* c, void* y, void* st, int bf16,
                                   int64_t bnc, int64_t q, int64_t h,
                                   int64_t p, int64_t n, void* stream) {
  if (bnc == 0 || h == 0) return static_cast<int>(cudaSuccess);
  if (bnc < 0 || bnc > 65535 || h < 0 || h > 65535 || q < 1 || q > kMaxQ ||
      p < 1 || p > 128 || n < 1) {
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
  prm.q = q;
  prm.h = h;
  prm.p = p;
  prm.n = n;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(prm, bnc, s)
                               : dispatch<float>(prm, bnc, s);
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
