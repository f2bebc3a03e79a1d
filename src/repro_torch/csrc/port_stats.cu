// Per-port load and nonzero-count statistics of demand matrices.
//
// Replaces the Pallas TPU kernel `port_stats_pallas`
// (src/repro/kernels/port_stats/kernel.py:37), which sums f32 copies of the
// demands.  The reference's main path packs its LP from host f64 sums
// (`repro.core.coflow.port_stats`, cast to f32 by `pack_lp_arrays`), so this
// kernel reads the f64 demands and sums in f64 in exactly NumPy's order:
//   * row sums (ingress ports) as NumPy's pairwise sum over a contiguous
//     axis: a plain loop below 8 terms; eight partials r[j] = a[j] + a[j+8]
//     + ..., each added in order, combined as ((r0+r1)+(r2+r3))+((r4+r5)+
//     (r6+r7)), then the tail one at a time, up to 128 terms; past 128 the
//     recursion splits at n2 = n/2 - (n/2) % 8 and adds the halves.  The
//     reduction adds that to its identity 0.0 (so a row of -0.0 sums to
//     +0.0, as on the host);
//   * column sums (egress ports) as one running sum from 0.0 down the rows.
// No FMA can arise (only adds), and no sum is split: a column has one
// owner thread that walks the rows in order.  So rho is bit-identical to
// the host's f64 values; tau counts entries > 0 exactly.
//
// What bounds it on an H100: bytes.  A matrix is 8 N^2 bytes in and 24 N
// out (f64 rho and int32 tau over 2N ports): 0.993 us at 3.35 TB/s for the
// main path's 3200 matrices of 10 ports, 14-29 us for the 256 and 526 of
// 150 ports.  At these sizes a block's time is a chain of latencies (copy
// issue, the data's arrival, the sums' dependent adds), so each route
// keeps few steps per block and many blocks or warps in flight.  Two
// routes, picked by `kernels/port_stats.py:plan`; `port_stats_dims`
// reports the launch the C entry derives from the plan:
//
//   * small (N up to 128, one leaf of NumPy's recursion: the main path's
//     10, the smoke's 48): a block takes a contiguous run of G matrices,
//     one range of the input, with every copy of it in flight at once
//     (`cp.async`, 8 bytes a copy: 16-byte copies into rows padded for
//     16-byte reads were slower at every width), into rows padded to an
//     odd stride (N | 1), at which one thread a row reads without bank
//     conflicts.  After one barrier each thread takes one
//     output (rows first, then columns, so that a warp mostly takes one
//     branch) and writes it into the block's contiguous range of rho and
//     tau.  Divisions by N use a reciprocal the C entry computes.  A grid
//     of a few blocks an SM replaces one block a matrix.
//   * stream (wide N: 150 ports of `wide` and `fb_full`, any N up to
//     `kMaxPorts`): one block a matrix; its rows pass once, in order,
//     through a ring of S slabs of R rows in shared memory.  A producer warp
//     issues a TMA bulk copy (`cp.async.bulk`) of each row's 16-byte-aligned
//     interior (and a `cp.async` of the element off the grid at either end
//     of a row where N is odd or the input is not aligned), counted on the
//     stage's `full` mbarrier; column warps and row warps wait on it, sum, and
//     arrive on the stage's `empty` mbarrier, which the producer waits on
//     before it refills the stage.  No block-wide barrier: each role runs
//     ahead of the others by up to the ring's depth.  Thread c owns column c
//     (and c + 512, ...: up to 16 columns a thread), reads the slab
//     coalesced, 8 rows' loads ahead of their adds, and keeps its running
//     sum and count in registers.  A row is summed by 8 lanes: lane j keeps
//     partial r[j]; three `__shfl_xor_sync` steps (1, 2, 4) give
//     ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) on every lane, since a + b == b + a
//     bit for bit; a row of 129 to about 250 terms sums its two leaves at
//     once.  Deeper recursions are called, in a kernel built for such rows
//     alone: a call site makes the compiler keep live values in local
//     memory (the small route took 6 % longer with one).  Rows are padded
//     to a stride of 8 mod 16 doubles, so the four rows a warp reads at
//     once fall on distinct banks.  Shared memory is S (R (N + 9) + 2)
//     doubles at most, not N^2.
//
// Shared memory above the default 48 KB is opted into once per device, for
// each kernel that the plan takes there.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kLeaf = 128;        // NumPy's PW_BLOCKSIZE
constexpr int kDepth = 7;         // recursion levels: leaves <= 128 up to 8192 terms
constexpr int kMaxPorts = 8192;   // kMaxColumns columns a thread of kMaxColumnThreads
constexpr int kMaxColumns = 16;   // columns a thread owns on the stream route
constexpr int kMaxColumnThreads = 512;
constexpr int kMaxSlabRows = 32;  // a row warp a step of 4 rows: at most 8 row warps
constexpr int kSmallThreads = 512;
constexpr int kStreamThreads = kMaxColumnThreads + 32 * (kMaxSlabRows / 4) + 32;
constexpr int kMaxStages = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 16;

// ---------------------------------------------------------------- row sums

// A sum and its count of entries > 0.
struct SumCount {
  double s;
  int c;
};

// NumPy's pairwise leaf (n <= 128) of a[0..n), one thread.
__device__ __forceinline__ SumCount leaf_serial(const double* a, int n) {
  int count = 0;
  if (n < 8) {
    double res = 0.0;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      res += a[i];
      count += a[i] > 0.0;
    }
    return {res, count};
  }
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r[j] = a[j];
    count += r[j] > 0.0;
  }
  int i = 8;
#pragma unroll 1
  for (; i < n - n % 8; i += 8) {
    double v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = a[i + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      r[j] += v[j];
      count += v[j] > 0.0;
    }
  }
  double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
#pragma unroll 1
  for (; i < n; ++i) {
    res += a[i];
    count += a[i] > 0.0;
  }
  return {res, count};
}

// r += a[8 t] for t in [0, steps), in order; 8 loads in flight ahead of
// their adds.
__device__ __forceinline__ void chain(const double* a, int steps, double& r, int& count) {
  int t = 0;
#pragma unroll 1
  for (; t + 8 <= steps; t += 8) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = a[8 * (t + u)];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      r += v[u];
      count += v[u] > 0.0;
    }
  }
#pragma unroll 1
  for (; t < steps; ++t) {
    const double v = a[8 * t];
    r += v;
    count += v > 0.0;
  }
}

// Two such chains at once (two leaves of a row), each in its own order.
__device__ __forceinline__ void chain2(const double* a, int sa, double& ra, const double* b,
                                       int sb, double& rb, int& count) {
  const int both = min(sa, sb);
  int t = 0;
#pragma unroll 1
  for (; t + 4 <= both; t += 4) {
    double va[4], vb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      va[u] = a[8 * (t + u)];
      vb[u] = b[8 * (t + u)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ra += va[u];
      rb += vb[u];
      count += (va[u] > 0.0) + (vb[u] > 0.0);
    }
  }
  chain(a + 8 * t, sa - t, ra, count);
  chain(b + 8 * t, sb - t, rb, count);
}

// Lane j's r[j] of 8 lanes -> ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) on every
// lane (a + b == b + a bit for bit).
__device__ __forceinline__ double combine8(double r) {
  constexpr unsigned kAll = 0xffffffffu;
  r += __shfl_xor_sync(kAll, r, 1);  // r0+r1, r2+r3, ...
  r += __shfl_xor_sync(kAll, r, 2);  // (r0+r1)+(r2+r3), ...
  return r + __shfl_xor_sync(kAll, r, 4);
}

__device__ __forceinline__ double tail8(const double* a, int n8, int n, int j, double r,
                                        int& count) {
#pragma unroll 1
  for (int i = n8; i < n; ++i) {
    r += a[i];
    count += (i - n8 == j) & (a[i] > 0.0);
  }
  return r;
}

// The 8 lanes of a group (lanes 8k .. 8k + 7 of a warp whose 32 lanes all
// take part, each group on its own row) sum a leaf of n <= 128 terms: lane
// j keeps r[j] = a[j] + a[j+8] + ... over the first n8 = n - n % 8 terms
// (its chain), `combine8` joins the eight, then the tail adds one at a
// time.  Lane j counts the entries of its chain and tail entry n8 + j.
__device__ __forceinline__ SumCount leaf_group(const double* a, int n, int j) {
  int count = 0;
  if (n < 8) {
    double res = 0.0;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      res += a[i];
      count += (i == j) & (a[i] > 0.0);
    }
    return {res, count};
  }
  const int n8 = n - n % 8;
  double r = a[j];
  count += r > 0.0;
  chain(a + 8 + j, n8 / 8 - 1, r, count);
  return {tail8(a, n8, n, j, combine8(r), count), count};
}

// Two leaves of >= 8 terms each, a[0..na) and b[0..nb), summed at once;
// returns leaf a + leaf b.
__device__ __forceinline__ SumCount leaves2_group(const double* a, int na, const double* b,
                                                  int nb, int j) {
  const int a8 = na - na % 8, b8 = nb - nb % 8;
  double ra = a[j], rb = b[j];
  int count = (ra > 0.0) + (rb > 0.0);
  chain2(a + 8 + j, a8 / 8 - 1, ra, b + 8 + j, b8 / 8 - 1, rb, count);
  constexpr unsigned kAll = 0xffffffffu;
  ra += __shfl_xor_sync(kAll, ra, 1);
  rb += __shfl_xor_sync(kAll, rb, 1);
  ra += __shfl_xor_sync(kAll, ra, 2);
  rb += __shfl_xor_sync(kAll, rb, 2);
  ra += __shfl_xor_sync(kAll, ra, 4);
  rb += __shfl_xor_sync(kAll, rb, 4);
  const double sa = tail8(a, a8, na, j, ra, count);
  return {sa + tail8(b, b8, nb, j, rb, count), count};
}

// NumPy's recursion above 128 terms; D levels left.
template <int D>
__device__ __noinline__ SumCount pairwise_group(const double* a, int n, int j) {
  if constexpr (D > 0) {
    if (n > kLeaf) {
      const int n2 = n / 2 - (n / 2) % 8;
      const SumCount left = pairwise_group<D - 1>(a, n2, j);
      const SumCount right = pairwise_group<D - 1>(a + n2, n - n2, j);
      return {left.s + right.s, left.c + right.c};
    }
  }
  return leaf_group(a, n, j);
}

// Whether a row of n > 128 terms is two leaves (n - n2 <= 128), or needs
// the recursion deeper.
__host__ __device__ inline bool two_leaves(int n) {
  return n - (n / 2 - (n / 2) % 8) <= kLeaf;
}

// A row's sum as the host reduction gives it: 0.0 + pairwise.  kDeep: the
// rows may need the recursion past two leaves, which is called (the call
// makes the compiler keep live values in memory around it, so kernels that
// never take it are built without it).
template <bool kDeep>
__device__ __forceinline__ SumCount row_group(const double* a, int n, int j) {
  SumCount r;
  if constexpr (kDeep) {
    if (n > kLeaf && !two_leaves(n)) {
      r = pairwise_group<kDepth>(a, n, j);
      r.s = 0.0 + r.s;
      return r;
    }
  }
  if (n <= kLeaf) {
    r = leaf_group(a, n, j);
  } else {
    const int n2 = n / 2 - (n / 2) % 8;
    r = leaves2_group(a, n2, a + n2, n - n2, j);
  }
  r.s = 0.0 + r.s;
  return r;
}

// ------------------------------------------------------------- async copy

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem(dst)), "l"(src)
               : "memory");
}

// Commits this thread's copies and waits for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count)
               : "memory");
}

// The one arrival of the barrier's phase, which then also waits for `bytes`
// of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar)) : "memory");
}

// The barrier's phase also waits for this thread's `cp.async` copies so far
// (its pending count rises by one now, and falls when they land).
__device__ __forceinline__ void mbar_track_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// A TMA bulk copy of `bytes` (a multiple of 16; both ends 16-byte aligned),
// counted on `bar`.
__device__ __forceinline__ void bulk_copy(double* dst, const double* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// Copies `count` consecutive doubles from `src` into rows of `n` at stride
// `P` in shared memory, 8 bytes a copy (any alignment), thread `tid` of
// `T` taking elements tid, tid + T, ...: every copy in flight at once.
// (row0, col0) = divmod(tid, n), (dq, dr) = divmod(T, n).
__device__ __forceinline__ void copy_rows(double* dst, const double* src, int count, int n,
                                          int P, int tid, int T, int row0, int col0, int dq,
                                          int dr) {
  int row = row0, col = col0;
#pragma unroll 1
  for (int e = tid; e < count; e += T) {
    cp_async8(dst + row * P + col, src + e);
    row += dq;
    col += dr;
    if (col >= n) {
      col -= n;
      ++row;
    }
  }
}

// ------------------------------------------------------------ small route

// Row stride of the small route: odd (n | 1), so that one thread a row,
// reading 8 bytes at a time, is free of bank conflicts.
__host__ __device__ inline int small_stride(int n) { return n | 1; }

// x / d for 0 <= x and x d < 2^32, given magic = ceil(2^32 / d) mod 2^32
// (the C entry computes it once a call: a division costs a warp some 20
// instructions, and the small route's blocks are short).
__device__ __forceinline__ int div_magic(int x, unsigned magic) {
  // magic 0: d = 1
  return magic ? static_cast<int>(__umulhi(static_cast<unsigned>(x), magic)) : x;
}

__host__ inline unsigned magic_of(int d) {
  return static_cast<unsigned>((0x100000000ull + d - 1) / d);
}

// The output thread t takes, t < 2 g n: rows first (t < g n: row t % n of
// matrix t / n), then the columns in the same order, so that a warp's
// lanes take the same branch but where the two meet and its stores fill
// runs of n consecutive outputs.
struct Output {
  int o;    // index in the block's run of outputs
  int off;  // the row's or column's first element in shared memory
  bool row;
};

__device__ __forceinline__ Output output_of(int t, int g, int n, int P, unsigned magic_n) {
  const bool row = t < g * n;
  const int t2 = row ? t : t - g * n;
  const int mi = div_magic(t2, magic_n);
  const int p = t2 - mi * n;
  return {mi * 2 * n + p + (row ? 0 : n), mi * n * P + (row ? p * P : p), row};
}

__device__ __forceinline__ SumCount small_output(const double* sh, const Output& w, int n,
                                                 int P) {
  if (w.row) {  // n <= 128: one leaf
    SumCount r = leaf_serial(sh + w.off, n);
    r.s = 0.0 + r.s;
    return r;
  }
  // A column: a running sum down the rows, 8 rows' loads ahead of their adds.
  SumCount sc{0.0, 0};
  const double* a = sh + w.off;
  int i = 0;
#pragma unroll 1
  for (; i + 8 <= n; i += 8) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = a[(i + u) * P];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      sc.s += v[u];
      sc.c += v[u] > 0.0;
    }
  }
#pragma unroll 1
  for (; i < n; ++i) {
    sc.s += a[i * P];
    sc.c += a[i * P] > 0.0;
  }
  return sc;
}

__global__ void __launch_bounds__(kSmallThreads, 2)
    port_stats_kernel_small(const double* __restrict__ demands, double* __restrict__ rho,
                            int* __restrict__ tau, int matrices, int n, int per_block,
                            unsigned magic_n) {
  extern __shared__ __align__(16) double sh[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * per_block;
  const int g = static_cast<int>(min(static_cast<long long>(per_block), matrices - m0));
  const int P = small_stride(n);
  const int row0 = div_magic(tid, magic_n), dq = div_magic(T, magic_n);
  copy_rows(sh, demands + m0 * n * n, g * n * n, n, P, tid, T, row0, tid - row0 * n, dq,
            T - dq * n);
  Output w = output_of(tid, g, n, P, magic_n);  // while the copies land
  cp_async_wait_all();
  __syncthreads();

#pragma unroll 1
  for (int t = tid; t < 2 * g * n; t += T) {
    if (t != tid) w = output_of(t, g, n, P, magic_n);
    const SumCount sc = small_output(sh, w, n, P);
    rho[m0 * 2 * n + w.o] = sc.s;
    tau[m0 * 2 * n + w.o] = sc.c;
  }
}

// ----------------------------------------------------------- stream route

// Row stride of a slab: at least n + 1 (a row off the 16-byte grid starts
// one double in), even, and 8 mod 16 doubles, so that the four rows a row
// warp reads at once (8 consecutive doubles each) fall on distinct banks
// two by two.
__host__ __device__ inline int stream_stride(int n) {
  return n + 1 + ((8 - (n + 1)) % 16 + 16) % 16;
}

// Whether a row starting at `p` begins one double off the 16-byte grid:
// its element c then sits at slot + 1 + c, else at slot + c.
__device__ __forceinline__ int odd_start(const double* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 3) & 1);
}

// Issues slab rows [r0, r0 + here) (here <= 32) into `buf`, lane l of the
// producer warp row r0 + l: a TMA bulk copy of the row's 16-byte-aligned
// interior, counted on `full`, and a `cp.async` of the element off the
// grid at either end, which `full` tracks too; then lane 0 arrives on
// `full` with the slab's bytes.
__device__ __forceinline__ void issue_slab(const double* mat, double* buf, uint64_t* full, int n,
                                           int P, int r0, int here, int lane) {
  const double* row = mat + static_cast<long long>(r0 + lane) * n;
  const int o = odd_start(row);
  const int body = lane < here ? (n - o) & ~1 : 0;
  // This warp's edge copies of an earlier slab precede the bulk copies.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane < here) {
    double* dst = buf + lane * P;
    if (body) bulk_copy(dst + 2 * o, row + o, 8u * body, full);
    const bool tail = o + body < n;
    if (o) cp_async8(dst + 1, row);
    if (tail) cp_async8(dst + o + n - 1, row + n - 1);
    if (o || tail) mbar_track_copies(full);
  }
  const unsigned bytes = __reduce_add_sync(0xffffffffu, 8u * body);
  __syncwarp();  // every lane's tracking before lane 0's arrival
  if (lane == 0) mbar_expect(full, bytes);
}

// Threads [0, col_threads) own the columns (c, c + col_threads, ...: C at
// most); the warps after them own the rows, 8 lanes a row, 4 rows a warp a
// step; the last warp issues the copies.  No block-wide barrier after the
// start: each stage has a `full` barrier (the copies landed) and an `empty`
// one (every column and row warp is done with it), so each role runs ahead
// of the others by up to the ring's depth.
template <int C, bool kDeep>
__global__ void __launch_bounds__(kStreamThreads)
    port_stats_kernel_stream(const double* __restrict__ demands, double* __restrict__ rho,
                             int* __restrict__ tau, int n, int rows, int stages,
                             int col_threads) {
  extern __shared__ __align__(16) double sh[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int P = stream_stride(n);
  const long long m = blockIdx.x;
  const double* mat = demands + m * n * n;
  const int slabs = (n + rows - 1) / rows;
  const int slab_doubles = rows * P;
  uint64_t* full = reinterpret_cast<uint64_t*>(sh + stages * slab_doubles);
  uint64_t* empty = full + stages;
  const int consumers = (T >> 5) - 1;  // column and row warps
  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int o_mat = odd_start(mat);
  const int o_step = n & 1;  // rows alternate off the grid where n is odd

  if (tid >= T - 32) {  // the producer
#pragma unroll 1
    for (int k = 0; k < slabs; ++k) {
      const int b = k % stages;
      if (k >= stages) mbar_wait(empty + b, (k / stages - 1) & 1);
      issue_slab(mat, sh + b * slab_doubles, full + b, n, P, k * rows, min(rows, n - k * rows),
                 lane);
    }
    return;
  }
  if (tid < col_threads) {
    // Columns: a running sum down the rows, in order; K rows' loads in
    // flight ahead of their adds.
    double col[C];
    int ccol[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      col[q] = 0.0;
      ccol[q] = 0;
    }
    constexpr int K = C >= 8 ? 1 : 8 / C;
#pragma unroll 1
    for (int k = 0; k < slabs; ++k) {
      const int b = k % stages;
      mbar_wait(full + b, (k / stages) & 1);
      const double* buf = sh + b * slab_doubles;
      const int r0 = k * rows;
      const int here = min(rows, n - r0);
      int l0 = 0;
#pragma unroll 1
      for (; l0 + K <= here; l0 += K) {
        double v[K][C];
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const double* row = buf + (l0 + u) * P + (o_mat ^ ((r0 + l0 + u) & o_step));
#pragma unroll
          for (int q = 0; q < C; ++q) {
            const int c = tid + q * col_threads;
            v[u][q] = c < n ? row[c] : 0.0;
          }
        }
#pragma unroll
        for (int u = 0; u < K; ++u) {
#pragma unroll
          for (int q = 0; q < C; ++q) {
            col[q] += v[u][q];
            ccol[q] += v[u][q] > 0.0;
          }
        }
      }
#pragma unroll 1
      for (; l0 < here; ++l0) {
        const double* row = buf + l0 * P + (o_mat ^ ((r0 + l0) & o_step));
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int c = tid + q * col_threads;
          const double v = c < n ? row[c] : 0.0;
          col[q] += v;
          ccol[q] += v > 0.0;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + b);
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int c = tid + q * col_threads;
      if (c < n) {
        rho[m * 2 * n + n + c] = col[q];
        tau[m * 2 * n + n + c] = ccol[q];
      }
    }
    return;
  }
  // Rows: every lane of the warp takes part in every step (a spare group
  // repeats the slab's last row), so the shuffles take the full mask.
  const int rw = (tid - col_threads) >> 5;
  const int row_warps = (T - 32 - col_threads) >> 5;
  const int j = lane & 7;  // a row's lane
#pragma unroll 1
  for (int k = 0; k < slabs; ++k) {
    const int b = k % stages;
    mbar_wait(full + b, (k / stages) & 1);
    const double* buf = sh + b * slab_doubles;
    const int r0 = k * rows;
    const int here = min(rows, n - r0);
#pragma unroll 1
    for (int base = rw * 4; base < here; base += row_warps * 4) {
      const int lr = min(base + (lane >> 3), here - 1);
      const SumCount sc =
          row_group<kDeep>(buf + lr * P + (o_mat ^ ((r0 + lr) & o_step)), n, j);
      int cnt = sc.c;
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 4);
      if (j == 0 && base + (lane >> 3) < here) {
        rho[m * 2 * n + r0 + lr] = sc.s;
        tau[m * 2 * n + r0 + lr] = cnt;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + b);
  }
}

// Raises `kernel`'s dynamic shared memory limit to the device's opt-in
// maximum (227 KB on Hopper) once per device: the attribute persists in the
// context, so later launches skip the host calls, and it is never lowered.
template <typename Kernel>
cudaError_t allow_max_smem(std::atomic<bool> (&done)[kMaxDevices], Kernel kernel) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

// A launch as the C entry unpacks and checks it: `threads` the block's,
// `col_threads` the stream route's column owners (the rest own rows).
struct Dims {
  int per, threads, col_threads, stages, columns;
  long long grid;
  size_t smem;
};

// Unpacks `plan` (the C entry's note) at (matrices, n), or false where the
// entry refuses it.
bool dims_of(int matrices, int n, long long plan, Dims* d) {
  d->per = static_cast<int>(plan & 0xfffff);
  const int threads = static_cast<int>((plan >> 20) & 0x7ff);
  d->stages = static_cast<int>((plan >> 31) & 0xf);
  if (matrices < 1 || n < 1 || n > kMaxPorts || d->per < 1 || threads < 32 ||
      threads % 32 != 0 || d->stages == 1 || d->stages > kMaxStages) {
    return false;
  }
  if (d->stages == 0) {  // small
    d->threads = threads;
    d->col_threads = 0;
    d->columns = 0;
    d->grid = (matrices + static_cast<long long>(d->per) - 1) / d->per;
    d->smem = static_cast<size_t>(d->per) * n * small_stride(n) * sizeof(double);
    return threads <= kSmallThreads && d->per <= matrices && n <= kLeaf;
  }
  const int need = (n + threads - 1) / threads;  // stream: a power of two
  d->columns = 1;
  while (d->columns < need) d->columns *= 2;
  d->col_threads = threads;
  d->threads = threads + 32 * ((d->per + 3) / 4) + 32;  // column owners, row warps, producer
  d->grid = matrices;
  d->smem = static_cast<size_t>(d->stages) * (d->per * stream_stride(n) + 2) * sizeof(double);
  return threads <= kMaxColumnThreads && d->columns <= kMaxColumns && d->per <= n &&
         d->per <= kMaxSlabRows;
}

// One launch of `kernel`; `raised` is its own opt-in flags.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, std::atomic<bool> (&raised)[kMaxDevices], const Dims& d,
                   cudaStream_t stream, Args... args) {
  if (d.smem > kDefaultSmem) {
    const cudaError_t err = allow_max_smem(raised, kernel);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(d.grid), d.threads, d.smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// `plan` packs the launch in one argument (each costs the caller's ctypes
// call time): bits 0-19 `per` (matrices a block on the small route, rows a
// slab on the stream route), 20-30 `threads` (the block's on the small
// route; the column owners on the stream route, which adds a row warp per 4
// rows of a slab), 31-34 `stages` (0: the small route; 2-8: the stream
// route's slabs in the ring).  Grid and shared memory are derived here.
extern "C" int port_stats(const void* demands, void* rho, void* tau, int matrices, int n,
                          long long plan, void* stream) {
  Dims d;
  if (!dims_of(matrices, n, plan, &d)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* in = static_cast<const double*>(demands);
  auto* r = static_cast<double*>(rho);
  auto* t = static_cast<int*>(tau);
  auto s = static_cast<cudaStream_t>(stream);
  static std::atomic<bool> raised[7][kMaxDevices];  // per kernel below
  cudaError_t err;
  if (d.stages == 0) {
    err = launch(port_stats_kernel_small, raised[0], d, s, in, r, t, matrices, n, d.per,
                 magic_of(n));
  } else if (d.columns == 1 && (n <= kLeaf || two_leaves(n))) {
    err = launch(port_stats_kernel_stream<1, false>, raised[1], d, s, in, r, t, n, d.per,
                 d.stages, d.col_threads);
  } else if (d.columns == 1) {
    err = launch(port_stats_kernel_stream<1, true>, raised[2], d, s, in, r, t, n, d.per,
                 d.stages, d.col_threads);
  } else if (d.columns == 2) {
    err = launch(port_stats_kernel_stream<2, true>, raised[3], d, s, in, r, t, n, d.per,
                 d.stages, d.col_threads);
  } else if (d.columns == 4) {
    err = launch(port_stats_kernel_stream<4, true>, raised[4], d, s, in, r, t, n, d.per,
                 d.stages, d.col_threads);
  } else if (d.columns == 8) {
    err = launch(port_stats_kernel_stream<8, true>, raised[5], d, s, in, r, t, n, d.per,
                 d.stages, d.col_threads);
  } else {
    err = launch(port_stats_kernel_stream<16, true>, raised[6], d, s, in, r, t, n, d.per,
                 d.stages, d.col_threads);
  }
  return static_cast<int>(err);
}

// The launch `port_stats` unpacks from `plan` at (matrices, n): `out` =
// {grid, threads, shared memory bytes} (`Plan` states the same).
extern "C" int port_stats_dims(int matrices, int n, long long plan, long long* out) {
  Dims d;
  if (!dims_of(matrices, n, plan, &d)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = d.grid;
  out[1] = d.threads;
  out[2] = static_cast<long long>(d.smem);
  return 0;
}
