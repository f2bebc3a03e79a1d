// Pair-space resolution round of the batched circuit calendar.
//
// Replaces the Pallas TPU kernel `pair_resolve_pallas`
// (src/repro/kernels/event_resolve/kernel.py:149).  For each member g of the
// (instance, core) batch, claim[g] is the N x N matrix of claiming head flow
// ids (int32; any value >= the member's flow count means "no claim") and
// idle[g] whether the pair may start now.  A pair starts iff it is idle and
// its claim is the minimum of its row (first claimer on the ingress port)
// and of its column (first claimer on the egress port).
//
// What bounds it on an H100: bytes.  A round reads 5 and writes 1 byte per
// pair: 83 KB at the main path's (96, 12, 12), 1.1 MB (0.33 us at 3.35
// TB/s) at the trace's (8, 152, 152).  At the main path's shape the launch
// floor (about 1 us) is what shows.  The first version gave each member one
// block of 128 threads, a serial load loop of 4-byte loads (180 dependent
// steps at N = 152) and one thread per whole row or column, so 8 members
// used 8 of 132 SMs.  Two routes now, picked from the shape by
// `kernels/pair_resolve.py:plan`, one launch per round on either:
//
//   * block (small N): one thread per pair and `per_block` whole members
//     per block.  Every claim is loaded at once (one load a thread, no
//     loop), one barrier, then each idle pair's thread takes its row and
//     column minimum from shared memory.
//   * cluster (wide N): a member over a thread block cluster of `cluster`
//     blocks (`cudaLaunchKernelEx`), each holding a slab of ceil(N / C)
//     rows.  The slab is loaded with 16-byte loads (N % 4 == 0, aligned
//     pointers; 4-byte loads otherwise); row minima by warp reduction
//     (`__reduce_min_sync`); partial column minima by one thread per
//     column over the slab (consecutive threads on consecutive words: no
//     bank conflict); `cluster.sync()`; the member's column minima from
//     every block's partials through distributed shared memory
//     (`map_shared_rank`); a second `cluster.sync()`, so no block exits
//     while another reads its partials; then the slab's starts, 4 pairs a
//     thread.
//
// The minimum of integers is order-free, so every route and grouping gives
// the same bits.  The TPU kernel carried ids as exact f32; here they stay
// int32, exact up to 2**31 - 1.  Both routes stay under the default 48 KB
// of shared memory (the block route holds at most 1024 claims; the cluster
// route (ceil(N/C) + 2) N + ceil(N/C) words: 30.8 KB at N = 240, C = 8),
// so no opt-in is needed; the C entry refuses a plan past it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBlockPairs = 1024;    // block route: pairs (threads) a block
constexpr int kClusterThreads = 256; // cluster route: threads a block
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr size_t kMaxSmem = 48 * 1024;

__global__ void __launch_bounds__(kBlockPairs) pair_resolve_kernel_block(
    const int* __restrict__ claim, const bool* __restrict__ idle,
    bool* __restrict__ start, int members, int n, int per_block) {
  extern __shared__ int c[];  // (per_block, n, n) claims of this block
  const int nn = n * n;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int count =
      static_cast<int>(min(static_cast<long long>(per_block), members - first)) * nn;
  const size_t base = static_cast<size_t>(first) * nn;
  const int e = threadIdx.x;
  int v = 0;
  bool id = false;
  if (e < count) {
    v = claim[base + e];
    id = idle[base + e];
    c[e] = v;
  }
  __syncthreads();
  if (e >= count) return;
  bool go = false;
  if (id) {
    const int p = e % nn;
    const int* row = c + (e - p) + (p / n) * n;
    const int* col = c + (e - p) + p % n;
    int rmin = INT_MAX;
    int cmin = INT_MAX;
    for (int k = 0; k < n; ++k) {
      rmin = min(rmin, row[k]);
      cmin = min(cmin, col[k * n]);
    }
    go = v == rmin && v == cmin;
  }
  start[base + e] = go;
}

__device__ __forceinline__ uint32_t starts4(int4 v, uint32_t idle, int rmin,
                                            const int* cmin) {
  return static_cast<uint32_t>((idle & 0xffu) && v.x == rmin && v.x == cmin[0]) |
         static_cast<uint32_t>((idle & 0xff00u) && v.y == rmin && v.y == cmin[1]) << 8 |
         static_cast<uint32_t>((idle & 0xff0000u) && v.z == rmin && v.z == cmin[2]) << 16 |
         static_cast<uint32_t>((idle & 0xff000000u) && v.w == rmin && v.w == cmin[3]) << 24;
}

template <bool kVec>
__global__ void __launch_bounds__(kClusterThreads) pair_resolve_kernel_cluster(
    const int* __restrict__ claim, const bool* __restrict__ idle,
    bool* __restrict__ start, int n, int rows) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int width = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r0 = rank * rows;
  const int nr = max(0, min(rows, n - r0));  // this block's rows
  const int count = nr * n;
  int* slab = smem;                // (rows, n) claims of this block's rows
  int* colpart = slab + rows * n;  // (n,) column minima over the slab
  int* colmin = colpart + n;       // (n,) column minima over the member
  int* rowmin = colmin + n;        // (rows,)
  const size_t base = static_cast<size_t>(blockIdx.x / width) * n * n +
                      static_cast<size_t>(r0) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  if (kVec) {
    const int4* from = reinterpret_cast<const int4*>(claim + base);
    int4* to = reinterpret_cast<int4*>(slab);
#pragma unroll 4
    for (int e = threadIdx.x; e < count / 4; e += blockDim.x) to[e] = from[e];
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < count; e += blockDim.x) slab[e] = claim[base + e];
  }
  __syncthreads();

  for (int r = warp; r < nr; r += warps) {  // warp-uniform: all lanes reduce
    int m = INT_MAX;
    for (int j = lane; j < n; j += 32) m = min(m, slab[r * n + j]);
    m = __reduce_min_sync(kFullMask, m);
    if (lane == 0) rowmin[r] = m;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int m = INT_MAX;
    for (int r = 0; r < nr; ++r) m = min(m, slab[r * n + j]);
    colpart[j] = m;
  }
  cluster.sync();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int m = INT_MAX;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {  // every rank's load in flight
      if (q < width) m = min(m, cluster.map_shared_rank(colpart, q)[j]);
    }
    colmin[j] = m;
  }
  // No block leaves, or reads its colmin, before every block has read
  // every partial.
  cluster.sync();

  if (kVec) {  // n % 4 == 0: a thread's 4 pairs lie in one row
    const int4* v4 = reinterpret_cast<const int4*>(slab);
    const uint32_t* idle4 = reinterpret_cast<const uint32_t*>(idle + base);
    uint32_t* start4 = reinterpret_cast<uint32_t*>(start + base);
    for (int e = threadIdx.x; e < count / 4; e += blockDim.x) {
      const int r = (4 * e) / n;
      start4[e] = starts4(v4[e], idle4[e], rowmin[r], colmin + (4 * e - r * n));
    }
  } else {
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int v = slab[e];
      start[base + e] = idle[base + e] && v == rowmin[e / n] && v == colmin[e % n];
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Dims {
  long long grid;
  int threads;
  size_t smem;
};

// The launch of `width` (the C entry's argument) at (members, n), or false
// where the entry refuses it.
bool dims_of(int members, int n, int width, Dims* d) {
  if (members < 1 || n < 1 || width == 0) return false;
  if (width < 0) {
    const long long per_block = -static_cast<long long>(width);
    const long long pairs = per_block * n * n;
    if (pairs > kBlockPairs) return false;
    d->grid = (members + per_block - 1) / per_block;
    d->threads = static_cast<int>((pairs + 31) / 32 * 32);
    d->smem = pairs * sizeof(int);
    return true;
  }
  if (width > kMaxCluster) return false;
  const size_t rows = (n + width - 1) / width;
  d->grid = static_cast<long long>(members) * width;
  d->threads = kClusterThreads;
  d->smem = (rows * n + 2 * static_cast<size_t>(n) + rows) * sizeof(int);
  return d->grid <= INT_MAX && d->smem <= kMaxSmem;
}

}  // namespace

// `width` < 0: the block route, -`width` members a block; else the cluster
// route, `width` blocks a member (one argument: each costs the caller's
// ctypes call time).  Shared memory and offsets are derived here.
extern "C" int pair_resolve(const void* claim, const void* idle, void* start,
                            int members, int n, int width, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int*>(claim);
  const auto* id = static_cast<const bool*>(idle);
  auto* st = static_cast<bool*>(start);
  Dims d;
  if (!dims_of(members, n, width, &d)) return static_cast<int>(cudaErrorInvalidValue);
  if (width < 0) {
    pair_resolve_kernel_block<<<static_cast<int>(d.grid), d.threads, d.smem, s>>>(
        c, id, st, members, n, -width);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = n % 4 == 0 && aligned(claim, 16) && aligned(idle, 4) && aligned(start, 4);
  auto* kernel = vec ? pair_resolve_kernel_cluster<true> : pair_resolve_kernel_cluster<false>;
  return static_cast<int>(repro::launch_clusters(
      kernel, static_cast<unsigned>(d.grid), d.threads, d.smem, width, s, c, id, st, n,
      (n + width - 1) / width));
}

// The launch `pair_resolve` derives from `width` at (members, n):
// `out` = {grid, threads, shared memory bytes} (`Plan` states the same).
extern "C" int pair_resolve_dims(int members, int n, int width, long long* out) {
  Dims d;
  if (!dims_of(members, n, width, &d)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = d.grid;
  out[1] = d.threads;
  out[2] = static_cast<long long>(d.smem);
  return 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
