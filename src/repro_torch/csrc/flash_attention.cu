// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// (loaded with ctypes by repro_torch/kernels/flash_attention.py).
//
// Replaces the Pallas kernel flash_attention_fwd (_flash_kernel) of
// src/repro/kernels/flash_attention.py: GQA online-softmax attention over
// q (B,Sq,H,D) and k, v (B,Skv,KV,D), query head h reading kv head
// h / (H/KV), with fp32 scores and accumulators, the masks kpos < Skv,
// causal kpos <= qpos and window kpos > qpos - W filled with -1e30, and the
// output acc / max(l, 1e-30) in q's dtype.  The TPU kernel carries m, l and
// acc in VMEM scratch across the sequential innermost grid axis; here one
// block owns a (batch, head, 64-row q tile) and loops over the kv tiles
// itself, holding m, l and acc in registers.  Nothing carries over between
// blocks.  The kernel reads q, k and v in place through their strides (the
// head dim must be unit-stride) and masks its own ragged edges, so there is
// no transpose and no padding in device memory.
//
// Bound: operations.  At the prefill shape (B,S,H,KV,D) = (4,2048,32,4,64),
// causal, the two products take 4*B*H*D*S*(S+1)/2 = 6.9e10 FLOP against
// 75.5 MB of q, k, v and o: 0.070 ms at the bf16 tensor-core peak against
// 0.023 ms at 3.35 TB/s.  This first version does all its arithmetic in
// fp32 on the CUDA cores (bf16 is widened with __bfloat162float on load), as
// the TPU kernel does (it casts q, k, v and p to f32): fp32 tolerances of
// 2e-5 rule out TF32 and bf16 tensor cores.  It is therefore many times its
// bound; a wgmma/TMA design is later work.
//
// Design: 256 threads as a 16 x 16 grid; thread (ty, tx) owns score rows
// 4*ty..4*ty+3 and columns tx + 16*j of each 64 x BK score tile, and the same
// rows and columns tx + 16*c of the 64 x D output, so the running max, sum and
// rescale of a row stay in the 16 lanes of one half-warp (shuffle
// reductions, no shared-memory round trip).  Q (pre-scaled by 1/sqrt(D), as
// the TPU kernel scales it), K, V and P tiles live in dynamic shared memory
// as fp32, padded so that the inner loops are free of bank conflicts.  The
// head dim is a template parameter padded to 32, 64, 128 or 256 with zeros
// (D = 112 runs as 128); at 256 the kv tile is 32 rows so the tiles fit in
// 141 KB.  Tiles wholly past the causal diagonal or wholly before the
// sliding window are skipped (the TPU kernel's should_run); q tiles are
// issued heaviest first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;           // score and output rows per thread
constexpr float kNegInf = -1e30f;  // the reference's fill, never -inf

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sq, skv, group, d;
  int64_t q_sb, q_ss, q_sh;  // batch, sequence and head strides (elements)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int causal;
  int64_t window;
  float scale;
};

template <int DP, int BK>
constexpr size_t smem_floats() {
  return kBlockQ * (DP + 4) + BK * (DP + 1) + BK * DP + kBlockQ * (BK + 4);
}

template <typename T, int DP, int BK>
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
  const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  for (int i = tid; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int64_t qpos = q0 + r;
    float x = 0.f;
    if (qpos < p.sq && c < p.d) x = to_float(qg[qpos * p.q_ss + c]) * p.scale;
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
        kx = to_float(kg[kpos * p.k_ss + c]);
        vx = to_float(vg[kpos * p.v_ss + c]);
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
      if (col < p.d) store(og + qpos * p.o_ss + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int DP, int BK>
cudaError_t launch(const Params& p, int64_t b, int64_t h,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats<DP, BK>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.sq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(h), static_cast<unsigned>(b));
  flash_fwd<T, DP, BK><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int64_t b, int64_t h,
                     cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32, 64>(p, b, h, stream);
  if (p.d <= 64) return launch<T, 64, 64>(p, b, h, stream);
  if (p.d <= 128) return launch<T, 128, 64>(p, b, h, stream);
  return launch<T, 256, 32>(p, b, h, stream);
}

}  // namespace

// o = attention(q, k, v) on `stream`.  q and o are (B,Sq,H,D), k and v
// (B,Skv,KV,D), all fp32 (bf16 == 0) or all bf16 (bf16 == 1), unit stride
// in D.  `strides` holds 12 element strides: (batch, sequence, head) of q,
// k, v and o in that order.  window == 0 means no sliding window.  Returns
// the cudaError_t of the launch.
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
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sq = sq;
  p.skv = skv;
  p.group = h / kvh;
  p.d = d;
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
  const cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(p, b, h, st)
                               : dispatch<float>(p, b, h, st);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
