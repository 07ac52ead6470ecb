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
// copy exists.  The dequantize writes only the first n elements, straight
// into the output of the source shape.
//
// Bit-exactness with the plain versions: the input is widened to fp32
// first (as astype(f32)); the scale is an IEEE fp32 division by 127; each
// element is DIVIDED by the scale (not multiplied by its reciprocal, which
// rounds differently); rintf rounds half to even, as jnp.round does; the
// clamp to +-127 follows.  The dequantize multiplies in fp32 and narrows
// with round-to-nearest-even intrinsics.
//
// Where the bytes go.  q (R x 512 int8) and s (R fp32) are two pointers:
// both on the card, or both in mapped pinned host memory, in the
// executor's case one packed buffer (R * 512 int8 bytes, then the R scales
// at the 16-byte aligned offset R * 512).  The kernel reads or writes host
// memory through its device mapping (the wrapper checks once that
// PyTorch's pinned blocks are mapped at their host address; each host
// launch checks that its operands are pinned).  A compressed swap-out is
// then one quantize launch that writes the host buffer over the link, a
// swap-in one dequantize launch that reads it: no device staging of q and
// s, no separate copies.
//
// Bounds, per call of n elements of itemsize b, R = ceil(n / 512):
//   card to card: HBM bytes.  Quantize reads n*b and writes n + 4R,
//     dequantize the reverse; 64 MiB fp32: 83.9 MB, 25.0 us at 3.35 TB/s.
//   host routes: the wire bytes n + 4R over the pinned link (the card's
//     copy-engine rate, 53.6 GB/s host to card and 55.0 GB/s card to host
//     on the H100 80GB HBM3 at 700 W, chip_smoke.py::measure_host_link);
//     64 MiB fp32: 16.9 MB, 0.31-0.32 ms.  The HBM side (67 MB, 20 us) is
//     hidden under it.
// What the design does about them:
//   * one warp per 512-element row, lane l owning 16 elements as groups of
//     16 bytes of the source type (4 fp32 or 8 bf16/fp16 elements, and as
//     many int8 bytes), group g at element g * 32 * E + l * E: every load
//     and store instruction of a warp on the source type's side covers one
//     contiguous 512-byte run of 16-byte vectors, and each int8 store of
//     the quantize a contiguous 128 (fp32) or 256 (16-bit) bytes;
//   * the dequantize reads each int8 row as one 16-byte load a lane (512
//     contiguous bytes a warp: over the link, reads in larger runs move
//     faster) and takes its groups from shared memory;
//   * a warp holds R rows at once, all their loads issued before any row is
//     reduced: R = 1 card to card (a full grid, one CTA per 8 rows, whose
//     warps hide HBM's latency), R = 4 on a host route (a capped grid; a
//     thread keeps 8-16 loads in flight over the link);
//   * a tile's 8 R scales go through shared memory and move as one
//     contiguous run (quantize writes them with one warp store, dequantize
//     reads them with one warp load), never as 4-byte scatters;
//   * absmax is a 5-step shuffle reduction;
//   * the tail row (n not a multiple of 512) and an x or out whose address
//     is not 16-byte aligned take a masked scalar path inside the same
//     body (a layout case, not a second kernel);
//   * a host-route launch runs on the executor's copy stream beside the
//     compute stream's kernels and mostly waits on the link, so it takes a
//     capped grid whose CTAs walk the tiles: per direction, the smallest
//     count of a sweep of 4, 8, 16, 32, 64 and 132 CTAs at 64 MiB fp32
//     (chip_smoke.py::quant_cta_sweep) that reaches 90 % of the measured
//     copy-engine rate.  On the H100 80GB HBM3 at 700 W the writes reach
//     0.913 of it at 16 CTAs (0.259, 0.512, 0.913, 0.923, 0.924, 0.917;
//     another call 0.906 at 16), the reads 0.907 only at 132, one CTA an
//     SM (0.302, 0.478, 0.636, 0.773, 0.887, 0.907): a read over the link
//     waits longer.  In another call the reads reached only 0.70 at any
//     count, so the executor reads over the link only packed buffers of
//     up to 1 MiB (at most 64 tiles, under either cap), where the route's
//     fixed cost decides, and copies larger ones to the card first.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;                 // elements per row (the TPU's)
constexpr int kWarp = 32;
constexpr int kPerLane = kBlock / kWarp;    // 16 elements a lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;    // 256
// CTAs of a launch that writes (quantize) or reads (dequantize) host
// memory: see the header.
constexpr int kQuantHostCtas = 16;
constexpr int kDequantHostCtas = 132;
// what ``offload_quantize``/``offload_dequantize`` return when a host
// operand is not pinned memory
constexpr int kNotPinned = -1;

// One element of a 32-bit word of raw bits (little-endian: element 0 is
// the low half), widened to fp32 exactly.
template <typename T>
__device__ __forceinline__ float word_elem(uint32_t w, int i);
template <>
__device__ __forceinline__ float word_elem<float>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float word_elem<__nv_bfloat16>(uint32_t w,
                                                          int i) {
  return __uint_as_float(i ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float word_elem<__half>(uint32_t w, int i) {
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>(i ? (w >> 16) : (w & 0xffffu))));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// fp32 narrowed to T (round to nearest even), as raw bits and as a value.
template <typename T>
__device__ __forceinline__ uint32_t elem_bits(float x);
template <>
__device__ __forceinline__ uint32_t elem_bits<float>(float x) {
  return __float_as_uint(x);
}
template <>
__device__ __forceinline__ uint32_t elem_bits<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ uint32_t elem_bits<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

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

// The layout of a row for source type T: a lane's 16 elements are G
// groups of E = 16 / sizeof(T) contiguous elements (one 16-byte vector of
// T, and E int8 bytes: one 32- or 64-bit word run); group g of lane l
// starts at element g * 32 * E + l * E.  So every load and store
// instruction of a warp covers one contiguous run (512 bytes of T, 128 or
// 256 bytes of int8).
template <typename T>
struct Row {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int G = kPerLane / E;
  static constexpr int kPerWord = 4 / sizeof(T);
  __device__ static int64_t at(int g, int lane) {
    return static_cast<int64_t>(g) * kWarp * E + lane * E;
  }
};

// E int8 bytes at p (4- or 8-byte aligned) as words, and back.
template <int E>
__device__ __forceinline__ void load_bytes(const int8_t* p,
                                           uint32_t (&w)[E / 4]) {
  if constexpr (E == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  }
}
template <int E>
__device__ __forceinline__ void store_bytes(int8_t* p,
                                            const uint32_t (&w)[E / 4]) {
  if constexpr (E == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// One CTA walks tiles of 8 * R rows (blockIdx.x, + gridDim.x, ...); warp
// w holds rows w, w + 8, ... of a tile, R at once, all of their loads
// issued before any row is reduced.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    quantize_rows(const T* __restrict__ x, int64_t n, int8_t* __restrict__ q,
                  float* __restrict__ s, int64_t rows, bool vec) {
  using L = Row<T>;
  constexpr int kTileRows = kWarps * R;
  __shared__ float scales[kTileRows];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kTileRows;
    float v[R][kPerLane];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t row = row0 + warp + j * kWarps;
      if (row >= rows) break;                  // warp-uniform
#pragma unroll
      for (int g = 0; g < L::G; ++g) {
        const int64_t i = row * kBlock + L::at(g, lane);
        float* out = v[j] + g * L::E;
        if (vec && i + L::E <= n) {
          const uint4 u = *reinterpret_cast<const uint4*>(x + i);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < L::E; ++e) {
            out[e] = word_elem<T>(w[e / L::kPerWord], e % L::kPerWord);
          }
        } else {
#pragma unroll
          for (int e = 0; e < L::E; ++e) {
            out[e] = i + e < n ? to_float(x[i + e]) : 0.0f;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = warp + j * kWarps;
      const int64_t row = row0 + r;
      if (row >= rows) break;                  // warp-uniform
      float amax = 0.0f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      const float scale = fmaxf(amax, 1e-12f) / 127.0f;
#pragma unroll
      for (int g = 0; g < L::G; ++g) {
        uint32_t w[L::E / 4] = {};
#pragma unroll
        for (int e = 0; e < L::E; ++e) {
          float t = rintf(v[j][g * L::E + e] / scale);
          t = fminf(fmaxf(t, -127.0f), 127.0f);
          w[e / 4] |= (static_cast<uint32_t>(static_cast<int>(t)) & 0xffu)
                      << (8 * (e % 4));
        }
        // q holds whole rows, and its base is 16-byte aligned
        store_bytes<L::E>(q + row * kBlock + L::at(g, lane), w);
      }
      if (lane == 0) scales[r] = scale;
    }
    __syncthreads();
    if (threadIdx.x < kTileRows && row0 + threadIdx.x < rows) {
      s[row0 + threadIdx.x] = scales[threadIdx.x];
    }
    __syncthreads();
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    dequantize_rows(const int8_t* __restrict__ q,
                    const float* __restrict__ s, int64_t n,
                    T* __restrict__ out, int64_t rows, bool vec) {
  using L = Row<T>;
  constexpr int kTileRows = kWarps * R;
  __shared__ float scales[kTileRows];
  // each warp's R rows of int8 as they arrived: 16 bytes a lane
  __shared__ uint4 staged[kWarps][R][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kTileRows;
    if (threadIdx.x < kTileRows && row0 + threadIdx.x < rows) {
      scales[threadIdx.x] = s[row0 + threadIdx.x];
    }
    // whole 512-byte rows, one 16-byte load a lane (the reads over the
    // link move best in such runs), all issued before the first is used
    uint4 raw[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t row = row0 + warp + j * kWarps;
      if (row >= rows) break;                  // warp-uniform
      raw[j] = *reinterpret_cast<const uint4*>(q + row * kBlock +
                                               lane * kPerLane);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (row0 + warp + j * kWarps >= rows) break;
      staged[warp][j][lane] = raw[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = warp + j * kWarps;
      const int64_t row = row0 + r;
      if (row >= rows) break;                  // warp-uniform
      const float scale = scales[r];
      const int8_t* bytes = reinterpret_cast<const int8_t*>(staged[warp][j]);
#pragma unroll
      for (int g = 0; g < L::G; ++g) {
        // this lane's group of the row layout, from shared memory
        uint32_t w[L::E / 4];
        load_bytes<L::E>(bytes + L::at(g, lane), w);
        float v[L::E];
#pragma unroll
        for (int e = 0; e < L::E; ++e) {
          const int8_t b = static_cast<int8_t>(
              (w[e / 4] >> (8 * (e % 4))) & 0xffu);
          v[e] = static_cast<float>(b) * scale;
        }
        const int64_t i = row * kBlock + L::at(g, lane);
        if (vec && i + L::E <= n) {
          uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < L::E; ++e) {
            o[e / L::kPerWord] |= elem_bits<T>(v[e])
                                  << (32 / L::kPerWord * (e % L::kPerWord));
          }
          *reinterpret_cast<uint4*>(out + i) = make_uint4(o[0], o[1], o[2],
                                                          o[3]);
        } else {
#pragma unroll
          for (int e = 0; e < L::E; ++e) {
            if (i + e < n) out[i + e] = from_float<T>(v[e]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Rows a warp holds at once: 1 card to card (a full grid, one CTA per 8
// rows, whose many warps hide the memory's latency), 4 on a host route
// (a capped grid: more loads in flight per thread).
constexpr int rows_per_warp(bool host) { return host ? 4 : 1; }

// CTAs of a launch over `rows` rows: card to card a full grid (one CTA a
// tile), on a host route at most `host_cap`; `ctas` > 0 caps it instead
// (the cap sweep).
int64_t grid_for(int64_t rows, bool host, int host_cap, int ctas) {
  const int64_t tile = kWarps * rows_per_warp(host);
  int64_t g = (rows + tile - 1) / tile;
  const int64_t cap = ctas > 0 ? ctas : (host ? host_cap : 0);
  if (cap > 0 && g > cap) g = cap;
  return g < 1 ? 1 : g;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool pinned(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();                        // clear the sticky-free error
    return false;
  }
  return a.type == cudaMemoryTypeHost;
}

template <typename T>
void launch_quantize(const void* x, int64_t n, int8_t* q, float* s,
                     int64_t rows, bool host, unsigned grid,
                     cudaStream_t st) {
  const auto* xt = static_cast<const T*>(x);
  const bool vec = aligned16(x);
  if (host) {
    quantize_rows<T, rows_per_warp(true)><<<grid, kThreads, 0, st>>>(
        xt, n, q, s, rows, vec);
  } else {
    quantize_rows<T, rows_per_warp(false)><<<grid, kThreads, 0, st>>>(
        xt, n, q, s, rows, vec);
  }
}

template <typename T>
void launch_dequantize(const int8_t* q, const float* s, int64_t n, void* out,
                       int64_t rows, bool host, unsigned grid,
                       cudaStream_t st) {
  auto* ot = static_cast<T*>(out);
  const bool vec = aligned16(out);
  if (host) {
    dequantize_rows<T, rows_per_warp(true)><<<grid, kThreads, 0, st>>>(
        q, s, n, ot, rows, vec);
  } else {
    dequantize_rows<T, rows_per_warp(false)><<<grid, kThreads, 0, st>>>(
        q, s, n, ot, rows, vec);
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16.

// Quantizes the n elements at `x` (on the card) into q (rows x 512 int8)
// and s (rows fp32), rows = ceil(n / 512), on `stream`.  With `host`, q
// and s lie in mapped pinned host memory (checked: kNotPinned if not)
// and the launch takes the host route's grid; `ctas` > 0 caps the grid
// instead.  q must be 16-byte aligned, s 4-byte aligned; x may have any
// alignment of its type.  Returns the cudaError_t of the launch.
extern "C" int offload_quantize(const void* x, int dtype, int64_t n,
                                void* q, void* s, int64_t rows, int host,
                                int ctas, void* stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaSuccess);
  if (rows * kBlock < n || !aligned16(q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (host && !(pinned(q) && pinned(s))) return kNotPinned;
  const int64_t blocks = grid_for(rows, host, kQuantHostCtas, ctas);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(s);
  const unsigned g = static_cast<unsigned>(blocks);
  switch (dtype) {
    case 0:
      launch_quantize<float>(x, n, qo, so, rows, host, g, st);
      break;
    case 1:
      launch_quantize<__nv_bfloat16>(x, n, qo, so, rows, host, g, st);
      break;
    case 2:
      launch_quantize<__half>(x, n, qo, so, rows, host, g, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Writes the first n elements of q * s (q: rows x 512 int8, s: rows fp32,
// rows = ceil(n / 512)) to `out` (on the card) in the given dtype, on
// `stream`.  With `host`, q and s lie in mapped pinned host memory
// (checked: kNotPinned if not) and the launch takes the host route's
// grid; `ctas` > 0 caps the grid instead.  q must be 16-byte aligned; out
// may have any alignment of its type.  Returns the cudaError_t of the
// launch.
extern "C" int offload_dequantize(const void* q, const void* s, int64_t n,
                                  void* out, int dtype, int host, int ctas,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (!aligned16(q)) return static_cast<int>(cudaErrorInvalidValue);
  if (host && !(pinned(q) && pinned(s))) return kNotPinned;
  const int64_t rows = (n + kBlock - 1) / kBlock;
  const int64_t blocks = grid_for(rows, host, kDequantHostCtas, ctas);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* si = static_cast<const float*>(s);
  const unsigned g = static_cast<unsigned>(blocks);
  switch (dtype) {
    case 0:
      launch_dequantize<float>(qi, si, n, out, rows, host, g, st);
      break;
    case 1:
      launch_dequantize<__nv_bfloat16>(qi, si, n, out, rows, host, g, st);
      break;
    case 2:
      launch_dequantize<__half>(qi, si, n, out, rows, host, g, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device address of the pinned host memory at `host`
// (cudaHostGetDevicePointer), into *device.  Returns the cudaError_t.
extern "C" int offload_quant_mapped_pointer(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}

// The CTA cap of a host-route launch: of the dequantize when `dequantize`
// is not 0, else of the quantize.
extern "C" int offload_quant_host_ctas(int dequantize) {
  return dequantize ? kDequantHostCtas : kQuantHostCtas;
}

extern "C" const char* offload_quant_error_string(int err) {
  if (err == kNotPinned) return "a host operand is not pinned memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
