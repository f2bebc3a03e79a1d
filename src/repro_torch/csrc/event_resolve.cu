// Flow-space resolution round of the batched circuit calendar.
//
// Replaces the Pallas TPU kernel `event_resolve_pallas`
// (src/repro/kernels/event_resolve/kernel.py:89, body
// `_event_resolve_kernel` at :58).  For each member g of the (instance,
// core) batch, at its instant t[g], over its F flows in priority order:
//
//   waiting = pending && rel <= t
//   idle    = waiting && free_in[src] <= t && free_out[dst] <= t
//   claim   = reserving ? waiting : idle
//   start   = idle && the flow is the first claimer on both its ports
//
// The kernel writes the (G, F) start mask, each port's first claimer
// (G, N) int32 (F where none claims; the calendar's free-time update reads
// them), and per member whether some idle flow did not start (the greedy
// calendar's test for another round at the same instant).  Times are f64,
// compared natively: the TPU kernel compared in f32, which would break the
// calendar's bit-identical establish and complete times.  The first
// claimer of a port is the minimum claiming flow id, an int32 `atomicMin`
// in shared memory (the TPU kernel's strictly-lower-triangular (F, F) x
// (F, N) product is O(F^2 N)): exact, and independent of the order in
// which threads or blocks arrive, so a call repeats its bits.  A flow
// skips its atomic when the flow just before it claims the same port (that
// flow's id is smaller): a coflow's consecutive flows share an ingress,
// and same-address shared atomics serialize.
//
// What bounds it on an H100: bytes.  A round reads the pending byte and
// writes the start byte of every slot, reads the f64 release of a pending
// flow and the two int32 ports of a waiting one, and 24 bytes per port and
// member: 1.925 us at 3.35 TB/s on the whole trace's (8, 266272, 152) with
// one live member; at the main path's (96, 336, 12) the launch floor
// (about 1 us) is what shows.  The first version ran one block per member
// (one SM for the trace's one live member) and a chain of four dependent
// loads per flow (pending, release, ports, free times).  Two routes now,
// picked from the shape by `kernels/event_resolve.py:plan`, one launch per
// round on either:
//
//   * block (small F: the main path, fig5): one block per member; every
//     operand of a flow loaded at once, so the chain is two loads deep
//     (operands, then free times).
//   * cluster (wide F: the whole trace): a member over a thread block
//     cluster of C blocks, each over its own range of `span` flows (a
//     multiple of 128).  Loads follow the data (bytes): the release only
//     where a flow pends, the ports only where one waits, and a warp with
//     nothing pending or waiting in a step only writes zero starts (the
//     padded members, the unreleased flows).  Each block claims into its
//     own 2N first-claimer slots; after `cluster.sync()` every block takes
//     the minimum over the group's slots through distributed shared memory
//     (`map_shared_rank`); a second `cluster.sync()` keeps every block
//     resident until all have read; rank 0 writes `first_in` / `first_out`.
//
// A lane takes V consecutive flows a step: V = 4 (one 4-byte pending load,
// two 16-byte release loads, 16-byte port loads) where F % 4 == 0 and the
// pointers are aligned, V = 1 otherwise; the plan asks for V = 1 where a
// block's flows fit one a thread (more warps: latency).  Pass 1 records
// the idle bits (bit i % 32 of word i / 32 of the block's range, in shared
// memory), claims, and writes a zero start byte for every flow; pass 2
// visits only the idle flows, takes their ports from registers (the last
// step that loaded them) or re-reads them (L1/L2), and writes the starts.
// `blocked` is the OR over the member's blocks: on the cluster route rank
// 0 writes false before the first cluster barrier and a block with a
// blocked idle flow writes true after the second.  Shared memory per
// block: 2N (block) or 4N (cluster) words plus ceil(span / 32) idle-bit
// words.  The cluster route stays under the default 48 KB (the plan takes
// the block route otherwise); the block route raises its limit to the
// device's opt-in maximum past 48 KB (227 KB on Hopper: about 1.85 million
// flows at 152 ports).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 16;

__device__ __forceinline__ int clamp_port(int p, int n) {
  // Ports of waiting flows lie in [0, n) by contract; the clamp only keeps
  // a malformed input inside the block's shared memory.
  return min(max(p, 0), n - 1);
}

template <int V>
__device__ __forceinline__ void load_flags(const bool* p, bool (&out)[V]) {
  if constexpr (V == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = (w >> (8 * k)) & 0xffu;
  } else {
    out[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void load_ints(const int* p, int (&out)[V]) {
  if constexpr (V == 4) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  } else {
    out[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void load_times(const double* p, double (&out)[V]) {
  if constexpr (V == 4) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else {
    out[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void store_zeros(bool* p) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = 0u;
  } else {
    p[0] = false;
  }
}

template <int V>
__device__ __forceinline__ bool any_of(const bool (&x)[V]) {
  bool a = false;
#pragma unroll
  for (int k = 0; k < V; ++k) a |= x[k];
  return a;
}

// Claims `port` for flow `id` unless the flow just before it (`prev`: its
// port if it claims, else -1) claims the same port: that flow's id is
// smaller, so the port's minimum is the same.  Consecutive flows often
// share a port (a coflow's flows from one ingress), and same-address
// shared atomics serialize.
__device__ __forceinline__ void claim(int* slots, bool claims, int port, int prev, int id) {
  if (claims && port != prev) atomicMin(&slots[port], id);
}

template <int V, bool kCluster>
__global__ void __launch_bounds__(1024) event_resolve_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const double* __restrict__ rel, const double* __restrict__ free_in,
    const double* __restrict__ free_out, const bool* __restrict__ pending,
    const double* __restrict__ t, bool* __restrict__ start,
    int* __restrict__ first_in, int* __restrict__ first_out,
    bool* __restrict__ blocked, int f, int n, int reserving, int span) {
  extern __shared__ int smem[];
  int width = 1;
  int rank = 0;
  if constexpr (kCluster) {
    width = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  int* fin = smem;       // (n,) first claimer per ingress port, this block
  int* fout = smem + n;  // (n,) ... per egress port
  int* gin = kCluster ? smem + 2 * n : fin;    // (n,) over the member
  int* gout = kCluster ? smem + 3 * n : fout;  // (n,)
  unsigned* idle_bits = reinterpret_cast<unsigned*>(smem + (kCluster ? 4 : 2) * n);
  const size_t g = blockIdx.x / width;
  const size_t fbase = g * f;
  const size_t nbase = g * n;
  const double tg = t[g];
  const long long lo64 = static_cast<long long>(rank) * span;
  const int lo = static_cast<int>(min(lo64, static_cast<long long>(f)));
  const int hi = static_cast<int>(min(lo64 + span, static_cast<long long>(f)));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = (blockDim.x >> 5) * 32 * V;  // flows a block takes a step

  for (int p = threadIdx.x; p < 2 * n; p += blockDim.x) smem[p] = f;
  if (kCluster && rank == 0 && threadIdx.x == 0) blocked[g] = false;
  __syncthreads();

  // Pass 1: idle bits, claims, zero starts.  A lane takes flows i .. i +
  // V - 1 of each step; `b` is the same on all lanes of a warp, so every
  // lane reaches the shuffles and the ballot.  The ports of the last step
  // that loaded them stay in registers for pass 2.
  int s[V];
  int d[V];
  int last = -1;
  for (int b = lo + warp * 32 * V; b < hi; b += stride) {
    const int i = b + lane * V;
    const bool in = i < hi;
    bool pend[V];
    bool wait[V];
    unsigned nib = 0;  // bit k: flow i + k is idle
#pragma unroll
    for (int k = 0; k < V; ++k) pend[k] = false;
    if (in) load_flags<V>(pending + fbase + i, pend);
    // On the cluster route a warp with nothing pending, or nothing
    // waiting, in this step only writes zero starts and idle bits.  The
    // block route runs straight through: a gate would put its loads behind
    // the pending flags, and its states are dense.
    bool any = any_of(pend);
    if (!kCluster || __any_sync(kFullMask, any)) {
      double r[V];
      if (kCluster ? any_of(pend) : in) load_times<V>(rel + fbase + i, r);
      if (!kCluster && in) {
        load_ints<V>(src + fbase + i, s);
        load_ints<V>(dst + fbase + i, d);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) wait[k] = pend[k] && r[k] <= tg;
      any = any_of(wait);
      if (kCluster && any) {
        load_ints<V>(src + fbase + i, s);
        load_ints<V>(dst + fbase + i, d);
      }
      last = b;
    }
    if (!kCluster || __any_sync(kFullMask, any)) {
      double fi[V];
      double fo[V];
      bool claims[V];
      int sk[V];
      int dk[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sk[k] = clamp_port(s[k], n);
        dk[k] = clamp_port(d[k], n);
        if (wait[k]) {
          fi[k] = free_in[nbase + sk[k]];
          fo[k] = free_out[nbase + dk[k]];
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const bool idle = wait[k] && fi[k] <= tg && fo[k] <= tg;
        nib |= static_cast<unsigned>(idle) << k;
        claims[k] = reserving ? wait[k] : idle;
      }
      // The flow before this lane's first is the previous lane's last.
      int prev_in = __shfl_up_sync(kFullMask, claims[V - 1] ? sk[V - 1] : -1, 1);
      int prev_out = __shfl_up_sync(kFullMask, claims[V - 1] ? dk[V - 1] : -1, 1);
      if (lane == 0) prev_in = prev_out = -1;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        claim(fin, claims[k], sk[k], prev_in, i + k);
        claim(fout, claims[k], dk[k], prev_out, i + k);
        prev_in = claims[k] ? sk[k] : -1;
        prev_out = claims[k] ? dk[k] : -1;
      }
    }
    if (in) store_zeros<V>(start + fbase + i);
    if constexpr (V == 4) {
      // Lanes 8j..8j+7 hold the 32 flows of word j of this step.
      unsigned word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(kFullMask, word, 1);
      word |= __shfl_xor_sync(kFullMask, word, 2);
      word |= __shfl_xor_sync(kFullMask, word, 4);
      if ((lane & 7) == 0 && in) idle_bits[(i - lo) >> 5] = word;
    } else {
      const unsigned word = __ballot_sync(kFullMask, nib);
      if (lane == 0) idle_bits[(b - lo) >> 5] = word;
    }
  }

  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      int a = f;
      int c = f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {  // every rank's loads in flight
        if (q < width) {
          const int* other = cluster.map_shared_rank(smem, q);
          a = min(a, other[p]);
          c = min(c, other[n + p]);
        }
      }
      gin[p] = a;
      gout[p] = c;
      if (rank == 0) {
        first_in[nbase + p] = a;
        first_out[nbase + p] = c;
      }
    }
    // Every block has read every block's slots, and gin / gout are whole.
    cluster.sync();
  } else {
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      first_in[nbase + p] = fin[p];
      first_out[nbase + p] = fout[p];
    }
  }

  // Pass 2: an idle flow starts iff it is the first claimer on both ports.
  int stuck = 0;
  for (int b = lo + warp * 32 * V; b < hi; b += stride) {
    const int i = b + lane * V;
    const unsigned nib =
        i < hi ? (idle_bits[(i - lo) >> 5] >> ((i - lo) & 31)) & ((1u << V) - 1u) : 0u;
    if (!nib) continue;
    int ss[V];
    int dd[V];
    if (b == last) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        ss[k] = s[k];
        dd[k] = d[k];
      }
    } else {
      load_ints<V>(src + fbase + i, ss);
      load_ints<V>(dst + fbase + i, dd);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if ((nib >> k) & 1u) {
        if (gin[clamp_port(ss[k], n)] == i + k && gout[clamp_port(dd[k], n)] == i + k) {
          start[fbase + i + k] = true;
        } else {
          stuck = 1;
        }
      }
    }
  }
  stuck = __syncthreads_or(stuck);
  if (threadIdx.x == 0) {
    if (!kCluster) {
      blocked[g] = stuck != 0;
    } else if (stuck) {
      blocked[g] = true;
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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

// A launch as the C entry unpacks and checks it.
struct Dims {
  int span, threads, cluster, vector;
  long long grid;
  size_t smem;
};

// Unpacks `plan` (the C entry's note) at (members, flows, ports), or false
// where the entry refuses it.  Shared memory: 2N (block) or 4N (cluster)
// words plus ceil(span / 32) idle-bit words.
bool dims_of(int members, int flows, int ports, long long plan, Dims* d) {
  d->span = static_cast<int>(plan & 0xffffffffLL);
  d->threads = static_cast<int>((plan >> 32) & 0x7ff);
  d->cluster = static_cast<int>((plan >> 43) & 0xf);
  d->vector = static_cast<int>((plan >> 47) & 0x7);
  if (d->cluster == 1) d->span = flows;
  d->grid = static_cast<long long>(members) * d->cluster;
  const bool bad =
      members < 1 || flows < 0 || flows > INT_MAX - (1 << 20) || ports < 1 ||
      d->threads < 32 || d->threads > 1024 || d->threads % 32 != 0 || d->cluster < 1 ||
      d->cluster > kMaxCluster || d->grid > INT_MAX || (d->vector != 1 && d->vector != 4) ||
      (d->cluster > 1 && (d->span < 128 || d->span % 128 != 0 ||
                          static_cast<long long>(d->span) * d->cluster < flows));
  if (bad) return false;
  const size_t words = (static_cast<size_t>(d->span) + 31) / 32;
  d->smem = ((d->cluster == 1 ? 2 : 4) * static_cast<size_t>(ports) + words) * sizeof(int);
  return d->cluster == 1 || d->smem <= kDefaultSmem;
}

struct Args {
  const int* src;
  const int* dst;
  const double* rel;
  const double* free_in;
  const double* free_out;
  const bool* pending;
  const double* t;
  bool* start;
  int* first_in;
  int* first_out;
  bool* blocked;
  int members, flows, ports, reserving;
  Dims d;
  cudaStream_t stream;
};

template <int V>
cudaError_t launch(const Args& a) {
  if (a.d.cluster == 1) {
    auto* kernel = event_resolve_kernel<V, false>;
    if (a.d.smem > kDefaultSmem) {
      static std::atomic<bool> raised[kMaxDevices];
      const cudaError_t err = allow_max_smem(raised, kernel);
      if (err != cudaSuccess) return err;
    }
    kernel<<<a.members, a.d.threads, a.d.smem, a.stream>>>(
        a.src, a.dst, a.rel, a.free_in, a.free_out, a.pending, a.t, a.start, a.first_in,
        a.first_out, a.blocked, a.flows, a.ports, a.reserving, a.d.span);
    return cudaGetLastError();
  }
  return repro::launch_clusters(
      event_resolve_kernel<V, true>, static_cast<unsigned>(a.d.grid), a.d.threads,
      a.d.smem, a.d.cluster, a.stream, a.src, a.dst, a.rel, a.free_in, a.free_out,
      a.pending, a.t, a.start, a.first_in, a.first_out, a.blocked, a.flows, a.ports,
      a.reserving, a.d.span);
}

}  // namespace

// `plan` packs the launch in one argument (each costs the caller's ctypes
// call time): bits 0-31 `span`, 32-42 `threads`, 43-46 `cluster`, 47-49
// `vector`.  `cluster` == 1: the block route (one block a member over all
// its flows; `span` is taken as `flows`); else the cluster route, `cluster`
// blocks a member over `span` flows each (a multiple of 128, `cluster *
// span >= flows`).  A lane takes `vector` flows a step (4 only where F % 4
// == 0 and the pointers are aligned; else 1).  Shared memory and offsets
// are derived here.
extern "C" int event_resolve(const void* src, const void* dst, const void* rel,
                             const void* free_in, const void* free_out,
                             const void* pending, const void* t, void* start,
                             void* first_in, void* first_out, void* blocked,
                             int members, int flows, int ports, int reserving,
                             long long plan, void* stream) {
  Dims d;
  if (!dims_of(members, flows, ports, plan, &d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const int*>(src), static_cast<const int*>(dst),
               static_cast<const double*>(rel), static_cast<const double*>(free_in),
               static_cast<const double*>(free_out), static_cast<const bool*>(pending),
               static_cast<const double*>(t), static_cast<bool*>(start),
               static_cast<int*>(first_in), static_cast<int*>(first_out),
               static_cast<bool*>(blocked), members, flows, ports, reserving, d,
               static_cast<cudaStream_t>(stream)};
  const bool vec = d.vector == 4 && flows % 4 == 0 && aligned(src, 16) &&
                   aligned(dst, 16) && aligned(rel, 16) && aligned(pending, 4) &&
                   aligned(start, 4);
  return static_cast<int>(vec ? launch<4>(a) : launch<1>(a));
}

// The launch `event_resolve` unpacks from `plan` at (members, flows,
// ports): `out` = {grid, threads, shared memory bytes} (`Plan` states the
// same).
extern "C" int event_resolve_dims(int members, int flows, int ports, long long plan,
                                  long long* out) {
  Dims d;
  if (!dims_of(members, flows, ports, plan, &d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = d.grid;
  out[1] = d.threads;
  out[2] = static_cast<long long>(d.smem);
  return 0;
}
