// Blocked int8 quantize / dequantize for the compressed swap path, for
// Hopper (sm_90a), with a plain C interface (loaded with ctypes by
// repro_torch/kernels/offload_quant.py).
//
// Replaces the two Pallas kernels of src/repro/kernels/offload_quant.py:
//   quantize_blocked   (_quant_kernel):   per row of 512 elements of the
//       flattened, zero-padded input: scale = max(absmax, 1e-12) / 127,
//       q = clip(round_half_even(x / scale), -127, 127)
//   dequantize_blocked (_dequant_kernel): x = q * scale in fp32, cast to the
//       source dtype, the pad stripped.
// The TPU kernels take a padded (R, 512) copy of the input; here the input
// is read in place, flattened, and elements past n read as 0, so no padded
// copy exists in device memory.  The dequantize writes only the first n
// elements, straight into the output of the source shape.
//
// Bit-exactness with the plain versions: the input is widened to fp32
// first (as astype(f32)); the scale is an IEEE fp32 division by 127; each
// element is DIVIDED by the scale (not multiplied by its reciprocal, which
// rounds differently); rintf rounds half to even, as jnp.round does.  The
// dequantize narrows with round-to-nearest-even intrinsics.
//
// Bound: memory.  Quantize reads n*itemsize bytes and writes n + 4*R;
// dequantize reads n + 4*R and writes n*itemsize.  At 3.35 TB/s a 64 MiB
// fp32 tensor takes about 25 us each way.
//
// Design: quantize runs one warp per row; lane l handles elements l,
// l+32, ..., so each of the 16 loads of a warp is one coalesced run, and the
// absmax is a 5-step shuffle reduction.  Dequantize runs one thread per
// element in a grid-stride loop.  Both are simple first versions; writing
// the int8 straight into pinned host memory is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;                 // elements per row (the TPU's)
constexpr int kWarp = 32;
constexpr int kPerLane = kBlock / kWarp;    // 16
constexpr int kRowsPerCta = 8;              // 8 warps of 32 threads
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void quantize_rows(const T* __restrict__ x, int64_t n,
                              int8_t* __restrict__ q, float* __restrict__ s,
                              int64_t rows) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerCta + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int64_t base = row * kBlock;
  float v[kPerLane];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int64_t i = base + j * kWarp + lane;
    v[j] = i < n ? to_float(x[i]) : 0.0f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float scale = fmaxf(amax, 1e-12f) / 127.0f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    float r = rintf(v[j] / scale);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    q[base + j * kWarp + lane] = static_cast<int8_t>(r);
  }
  if (lane == 0) s[row] = scale;
}

template <typename T>
__global__ void dequantize_elems(const int8_t* __restrict__ q,
                                 const float* __restrict__ s, int64_t n,
                                 T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = from_float<T>(static_cast<float>(q[i]) * s[i / kBlock]);
  }
}

int64_t grid_for(int64_t units, int64_t per_cta) {
  int64_t g = (units + per_cta - 1) / per_cta;
  const int64_t cap = 32 * 132;              // enough waves over 132 SMs
  if (g > cap) g = cap;
  return g < 1 ? 1 : g;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16.

// Quantizes the n elements at `x` into q (rows x 512 int8) and s (rows
// fp32), rows = ceil(n / 512), on `stream`.  Returns the cudaError_t of the
// launch.
extern "C" int offload_quantize(const void* x, int dtype, int64_t n,
                                void* q, void* s, int64_t rows,
                                void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (rows * kBlock < n) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + kRowsPerCta - 1) / kRowsPerCta;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(s);
  const unsigned g = static_cast<unsigned>(blocks);
  switch (dtype) {
    case 0:
      quantize_rows<float><<<g, kThreads, 0, st>>>(
          static_cast<const float*>(x), n, qo, so, rows);
      break;
    case 1:
      quantize_rows<__nv_bfloat16><<<g, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), n, qo, so, rows);
      break;
    case 2:
      quantize_rows<__half><<<g, kThreads, 0, st>>>(
          static_cast<const __half*>(x), n, qo, so, rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Writes the first n elements of q * s (q: rows x 512 int8, s: rows fp32)
// to `out` in the given dtype, on `stream`.  Returns the cudaError_t of the
// launch.
extern "C" int offload_dequantize(const void* q, const void* s, int64_t n,
                                  void* out, int dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* si = static_cast<const float*>(s);
  const unsigned g = static_cast<unsigned>(grid_for(n, kThreads));
  switch (dtype) {
    case 0:
      dequantize_elems<float><<<g, kThreads, 0, st>>>(
          qi, si, n, static_cast<float*>(out));
      break;
    case 1:
      dequantize_elems<__nv_bfloat16><<<g, kThreads, 0, st>>>(
          qi, si, n, static_cast<__nv_bfloat16*>(out));
      break;
    case 2:
      dequantize_elems<__half><<<g, kThreads, 0, st>>>(
          qi, si, n, static_cast<__half*>(out));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* offload_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
