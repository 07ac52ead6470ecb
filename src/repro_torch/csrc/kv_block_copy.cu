// Batched KV-block copy for Hopper (sm_90a), with a plain C interface
// (loaded with ctypes by repro_torch/kernels/kv_block_copy.py).
//
// Replaces the two Pallas kernels of src/repro/kernels/kv_block_copy.py:
//   kv_block_gather  (_copy_kernel):    out[k]       = pool[idx[k]]
//   kv_block_scatter (_scatter_kernel): pool[idx[k]] = blocks[k]
// over a 2-D row pool, which the JAX engine makes of each cache leaf with
// moveaxis(leaf, a, 0).reshape(N, -1).  Here one launch moves the rows of
// up to kMaxLeaves cache leaves, each read or written in place through its
// layout, so no row pool is ever made:
//
//   A contiguous leaf of shape (outer..., N, rest...) with its slot on axis
//   a holds slot s as prod(outer) segments of seg = prod(rest) * itemsize
//   bytes, segment o at byte o * N * seg + s * seg.  A gather copies segment
//   (k, o) to byte (k * outer + o) * seg of a contiguous (K, outer...,
//   rest...) buffer, which is moveaxis(leaf, a, 0).reshape(N, -1)[idx]; a
//   scatter copies it back.
//
// The TPU kernels receive the indices by scalar prefetch before the grid
// runs.  Here they travel the same way: the K row indices and the leaf
// descriptors are the kernel's __grid_constant__ parameter block (under the
// classic 4 KB limit), so a call makes no index tensor, no host-to-device
// copy and no stream synchronisation.
//
// Bound: memory.  A call moves 2 * K * sum(outer * seg) bytes (each byte
// read once and written once), so its least time is that over 3.35 TB/s.
// At Mamba-2 780M's fp32 state leaf, K = 2 rows of 75.5 MB, that is
// 0.0901 ms; at TinyLlama's two KV leaves, 1.44 MB, the launch dominates.
//
// Design: the byte space of all (leaf, k, o) segments is cut into tiles of
// kTile bytes (a segment's last tile may be short), and a persistent grid
// (kCtasPerSm CTAs per SM) walks the tiles grid-stride.  Every thread of a
// CTA copies its share of a tile with kUnroll loads of 16 bytes in flight
// before their stores, and an unaligned part in the widest unit (16, 8, 4,
// 2 or 1 bytes) that its source and destination allow.  The copy is of
// bytes, so it is bit-exact for every dtype.  A ring of cp.async.bulk
// copies through shared memory measured no faster (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxRows = 512;
constexpr int kMaxLeaves = 16;
constexpr int64_t kTile = 32 * 1024;  // bytes of one tile
constexpr int kThreads = 256;
constexpr int kUnroll = 8;            // 16-byte loads in flight a thread
constexpr int kCtasPerSm = 2;

struct Leaf {
  char* leaf;            // the cache leaf, contiguous
  char* rows;            // the contiguous (K, outer..., rest...) buffer
  int64_t seg;           // bytes of one segment: prod(rest) * itemsize
  int64_t outer_stride;  // bytes between outer indices of the leaf: N * seg
  int64_t outer;         // prod(shape[:a])
  int64_t tiles_per_seg;
  int64_t first_tile;    // the call's index of this leaf's first tile
};

struct Params {
  Leaf leaves[kMaxLeaves];
  int32_t idx[kMaxRows];
  int64_t total_tiles;
  int32_t n_leaves;
  int32_t gather;        // 1: leaf -> rows, 0: rows -> leaf
};
static_assert(sizeof(Params) <= 4096, "parameter block over 4 KB");

struct Piece {
  const char* src;
  char* dst;
  int64_t n;
};

// Tile t of the call: its source, destination and byte count.
__device__ __forceinline__ Piece tile_at(const Params& p, int64_t t) {
  int l = 0;
  while (l + 1 < p.n_leaves && t >= p.leaves[l + 1].first_tile) ++l;
  const Leaf& lf = p.leaves[l];
  const int64_t r = t - lf.first_tile;
  const int64_t seg_i = r / lf.tiles_per_seg;       // k * outer + o
  const int64_t off = (r - seg_i * lf.tiles_per_seg) * kTile;
  const int64_t k = seg_i / lf.outer;
  const int64_t o = seg_i - k * lf.outer;
  char* in_leaf = lf.leaf + o * lf.outer_stride +
                  static_cast<int64_t>(p.idx[k]) * lf.seg + off;
  char* in_rows = lf.rows + seg_i * lf.seg + off;
  const int64_t n = lf.seg - off < kTile ? lf.seg - off : kTile;
  return p.gather ? Piece{in_leaf, in_rows, n} : Piece{in_rows, in_leaf, n};
}

template <typename T>
__device__ __forceinline__ void copy_units(char* dst, const char* src,
                                           int64_t units, int tid, int nthr) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  int64_t i = tid;
  for (; i + static_cast<int64_t>(kUnroll - 1) * nthr < units;
       i += static_cast<int64_t>(kUnroll) * nthr) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[i + u * nthr];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[i + u * nthr] = v[u];
  }
  for (; i < units; i += nthr) d[i] = s[i];
}

// n bytes from src to dst by threads tid of nthr (nthr >= 16): a head of
// bytes up to src's alignment in the widest unit that src and dst share,
// that unit's body, and a tail of bytes.
__device__ void copy_bytes(char* dst, const char* src, int64_t n, int tid,
                           int nthr) {
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(src) ^
                         reinterpret_cast<uintptr_t>(dst)) | 16;
  const int unit = static_cast<int>(mis & (~mis + 1));  // 1, 2, 4, 8 or 16
  int64_t head = static_cast<int64_t>(
      (unit - (reinterpret_cast<uintptr_t>(src) & (unit - 1))) & (unit - 1));
  if (head > n) head = n;
  if (tid < head) dst[tid] = src[tid];
  src += head;
  dst += head;
  n -= head;
  const int64_t units = n / unit;
  switch (unit) {
    case 16: copy_units<uint4>(dst, src, units, tid, nthr); break;
    case 8: copy_units<uint2>(dst, src, units, tid, nthr); break;
    case 4: copy_units<uint32_t>(dst, src, units, tid, nthr); break;
    case 2: copy_units<uint16_t>(dst, src, units, tid, nthr); break;
    default: copy_units<uint8_t>(dst, src, units, tid, nthr); break;
  }
  const int64_t done = units * unit;
  if (tid < n - done) dst[done + tid] = src[done + tid];
}

__global__ void __launch_bounds__(kThreads)
    copy_tiles(const __grid_constant__ Params p) {
  for (int64_t t = blockIdx.x; t < p.total_tiles; t += gridDim.x) {
    const Piece pc = tile_at(p, t);
    copy_bytes(pc.dst, pc.src, pc.n, threadIdx.x, kThreads);
  }
}

constexpr int kMaxDevices = 64;

// The current device's SM count (looked up once per device), or 0 on
// failure.
int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 0;
  }
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess) {
    counts[dev] = 0;
  }
  return counts[dev];
}

}  // namespace

// One launch copies K slot rows of n_leaves cache leaves.  `leaves` holds
// 5 int64 per leaf: the leaf's address, the rows buffer's address, outer,
// N and seg (bytes), as the header describes; `idx` the K int32 slot
// indices (each in [0, N) of every leaf: the caller checks).  gather 1
// copies leaf -> rows, 0 rows -> leaf.  Runs on `stream`; returns the
// cudaError_t of the launch.
extern "C" int kv_block_copy(int gather, int n_leaves, const int64_t* leaves,
                             int k, const int32_t* idx, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || k < 0 || k > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  int64_t tiles = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const int64_t* w = leaves + 5 * l;
    Leaf& lf = p.leaves[l];
    lf.leaf = reinterpret_cast<char*>(w[0]);
    lf.rows = reinterpret_cast<char*>(w[1]);
    lf.outer = w[2];
    lf.seg = w[4];
    lf.outer_stride = w[3] * w[4];
    lf.tiles_per_seg = (lf.seg + kTile - 1) / kTile;
    lf.first_tile = tiles;
    if (lf.outer <= 0 || lf.seg <= 0) {  // a leaf with nothing to move
      lf.outer = 1;
      lf.tiles_per_seg = 1;
      continue;
    }
    tiles += static_cast<int64_t>(k) * lf.outer * lf.tiles_per_seg;
  }
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  memcpy(p.idx, idx, sizeof(int32_t) * static_cast<size_t>(k));
  p.total_tiles = tiles;
  p.n_leaves = n_leaves;
  p.gather = gather != 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  if (sms <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err
                                               : cudaErrorInvalidDevice);
  }
  const int64_t cap = static_cast<int64_t>(kCtasPerSm) * sms;
  const unsigned grid = static_cast<unsigned>(tiles < cap ? tiles : cap);
  copy_tiles<<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kv_block_copy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
