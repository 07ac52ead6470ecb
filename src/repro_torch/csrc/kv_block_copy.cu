// Batched KV-block row copy for Hopper (sm_90a), with a plain C interface
// (loaded with ctypes by repro_torch/kernels/kv_block_copy.py).
//
// Replaces the two Pallas kernels of src/repro/kernels/kv_block_copy.py:
//   kv_block_gather  (_copy_kernel):    out[k]       = pool[idx[k]]
//   kv_block_scatter (_scatter_kernel): pool[idx[k]] = blocks[k]
// Both are a copy of K rows with an index on one side, so one kernel does
// both: `src_idx` or `dst_idx` is null where the row number is k itself.
// The TPU kernels receive the indices by scalar prefetch before the grid
// runs; here each block reads its own idx[k].
//
// Bound: memory.  A call moves 2*K*W*itemsize bytes (each row read once
// and written once), so its least time is that over 3.35 TB/s.  At the
// serving shapes (K <= 4 rows of 352 KiB) that is a fraction of a
// microsecond and the launch itself dominates; making that cheaper (fusing
// the per-leaf launches, CUDA graphs) is later work.
//
// Design: grid (chunks, K), one block per (chunk of a row, row k).  Each
// thread copies a grid-stride share of its row, 16 bytes at a time when the
// row's byte width and both base pointers are 16-byte aligned, otherwise in
// the widest unit (8, 4, 2 or 1 bytes) they allow.  The kernel copies
// bytes, so it serves every dtype.  Neighbouring threads touch neighbouring
// addresses, so every load and store is coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTargetBlocks = 4 * 132;  // a few waves over the 132 SMs

template <typename T>
__global__ void copy_rows(const T* __restrict__ src,
                          const int32_t* __restrict__ src_idx,
                          T* __restrict__ dst,
                          const int32_t* __restrict__ dst_idx,
                          int64_t row_units) {
  const int64_t k = blockIdx.y;
  const int64_t s = src_idx != nullptr ? static_cast<int64_t>(src_idx[k]) : k;
  const int64_t d = dst_idx != nullptr ? static_cast<int64_t>(dst_idx[k]) : k;
  const T* from = src + s * row_units;
  T* to = dst + d * row_units;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < row_units; i += stride) {
    to[i] = from[i];
  }
}

template <typename T>
cudaError_t launch(const void* src, const int32_t* src_idx, void* dst,
                   const int32_t* dst_idx, int64_t k, int64_t row_bytes,
                   cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(T));
  int64_t blocks_x = (units + kThreads - 1) / kThreads;
  const int64_t cap = (kTargetBlocks + k - 1) / k;
  if (blocks_x > cap) blocks_x = cap;
  if (blocks_x < 1) blocks_x = 1;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(k));
  copy_rows<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), src_idx, static_cast<T*>(dst), dst_idx,
      units);
  return cudaGetLastError();
}

}  // namespace

// Copies K rows of `row_bytes` bytes: row (src_idx ? src_idx[k] : k) of
// `src` to row (dst_idx ? dst_idx[k] : k) of `dst`, on `stream`.  The index
// arrays are int32 on the device.  Returns the cudaError_t of the launch.
extern "C" int kv_block_copy_rows(const void* src, const void* src_idx,
                                  void* dst, const void* dst_idx, int64_t k,
                                  int64_t row_bytes, void* stream) {
  if (k <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  if (k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* si = static_cast<const int32_t*>(src_idx);
  const auto* di = static_cast<const int32_t*>(dst_idx);
  const auto st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(row_bytes);
  cudaError_t err;
  if (align % 16 == 0) {
    err = launch<uint4>(src, si, dst, di, k, row_bytes, st);
  } else if (align % 8 == 0) {
    err = launch<uint2>(src, si, dst, di, k, row_bytes, st);
  } else if (align % 4 == 0) {
    err = launch<uint32_t>(src, si, dst, di, k, row_bytes, st);
  } else if (align % 2 == 0) {
    err = launch<uint16_t>(src, si, dst, di, k, row_bytes, st);
  } else {
    err = launch<uint8_t>(src, si, dst, di, k, row_bytes, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* kv_block_copy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
