// The banded bsgs preconditioner apply at 1x1 blocks (the scalar diffusion)
// for Hopper (sm_90a), as one launch of independent thread-block clusters,
// bound through a plain C interface.
//
// Replaces the TPU kernel `_banded_apply` / `_apply_kernel` (the JAX
// package's solver/pallas_banded.py:107) in the role that
// `make_banded_bsgs_pallas` (:193) gives it, where the blocks are 1x1 and
// no band wraps: one launch computes
//
//     z = D^-1 v;   `sweeps` times:  z <- D^-1 v - sum_k (D^-1 N)_k z_(c+s_k)
//
// with the cell arithmetic of banded_block.cuh (the bands in order k, one
// multiply-add each, then b + (-1) * acc), so the result equals that of the
// seven-launch banded_apply sequence value for value, as banded_bsgs.cu's
// does. banded_bsgs.cu's cooperative kernel stays the design for 4x4 blocks
// and for any structure whose bands wrap.
//
// What bounds it. By bytes: the four dense bands, D^-1, v and the output
// of the 512x512 heat equation (262,144 cells) are 14.67 MB at f64, 4.38 us
// at 3.35 TB/s (2.19 us at f32); its operations are far below the card's
// rate. The cooperative kernel runs seven phases chained through flags in
// device memory, each with a fixed cost of 3.8 us (f32) to 5.7 us (f64)
// where its data is negligible, so it took about 30 us at both precisions
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
//
// What the design does about it. With signed shifts s_k (h = max |s_k|)
// and no band reading across the wrap, an output cell after S sweeps
// depends only on inputs within S * h cells of it. So:
//   - cluster g of the grid owns the cells [g R, (g + 1) R) and computes
//     its window W_g = [g R - S h, (g + 1) R + S h) clipped to [0, NC),
//     recomputing the halo its neighbours also compute: no cluster reads
//     another's data, no phase waits on device memory, and co-residency is
//     never assumed (a second wave of clusters is slower, not wrong: the
//     launch is not cooperative);
//   - the window is cut into C slices of L cells, one per CTA (slice
//     starts 16-byte aligned: the window's start is rounded down to 16
//     bytes). Each CTA keeps its slice of the K band planes in shared
//     memory, and three buffers of its slice with G ghost cells on either
//     side (G: h in 16-byte runs): D^-1 v and two z buffers, K L + 3 (L +
//     2 G) values. Its thread 0 brings the band planes in by
//     `cp.async.bulk` (TMA) completing on an mbarrier while the threads
//     compute D^-1 v from device memory, over the ghosts too, so that no
//     CTA waits for another before sweep 1. A thread keeps the bands and
//     D^-1 v of its first cells (up to 3, reg_cells) in registers for the
//     whole apply, so a sweep reads only z from shared memory there;
//   - sweep s updates only the cells of the shrinking trapezoid
//     [g R - (S - s) h, (g + 1) R + (S - s) h) clipped to [0, NC), which is
//     all that sweep S's owned cells need, reading only its own shared
//     memory: a CTA writes each cell within G of its slice's ends also into
//     the ghosts of the CTAs beside it, through distributed shared memory
//     (mapa + st.shared::cluster, push_ghost; about 2 G stores a CTA a
//     sweep, which nobody waits on). The cells where every band is present
//     (all but the domain's first and last rows of the heat equation) skip
//     the support tests. The last sweep writes the owned cells to `out`,
//     coalesced;
//   - one hardware cluster barrier after each sweep but the last (a CTA
//     barrier, one cluster-scope fence, then barrier.cluster arrive /
//     wait.acquire); sweep 1 waits only for every CTA to have started
//     (an arrival at entry) before its pushes.
//     Sweep s reads buffer s - 1 and writes buffer s, where buffer 0 is
//     D^-1 v and the others alternate between the two z buffers. The
//     barrier after sweep s orders read-after-write: sweep s + 1 reads the
//     ghosts the other CTAs pushed in sweep s. The same barrier orders
//     write-after-read: sweep s + 1 writes and pushes into the buffers of
//     sweep s - 1, which every CTA had finished reading (in sweep s) before
//     arriving. Sweep S pushes nothing, so after the barrier before it no
//     CTA touches another's shared memory, and a CTA may leave;
//   - the band count K is a template argument, so the band loop unrolls.
// Buffers D^-1 v and z live only in shared memory: the kernel allocates
// nothing and keeps no state between launches, so an apply captured in a
// CUDA graph replays as it runs eagerly.
//
// Clusters of C = 8 CTAs are portable; 16 are allowed where
// cudaOccupancyMaxActiveClusters says the card takes them. A launch the
// card refuses returns its error: there is no fallback.

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <cstdlib>

#include "banded_block.cuh"
#include "bulk_copy.cuh"

// Mirrors the ctypes Structure `BsgsClusterArgs` in solver/banded_kernels.py.
struct BsgsClusterArgs {
  const void* dinv;    // (NC,) D^-1 (1x1 blocks)
  const void* dn;      // (K, ld) D^-1 N, plane stride ld
  int device;
  int nc;
  int ld;              // plane stride of dn, >= nc, 16-byte runs
  int nbands;
  int sweeps;
  int cluster;         // C, CTAs of a cluster
  int clusters;        // G, clusters of the grid
  int owned;           // R: cluster g owns [g R, min((g + 1) R, nc))
  int reach;           // h = max_k |s_k|
  int slice;           // L, cells of a CTA's slice, 16-byte runs
  int smem_bytes;      // dynamic shared memory per CTA
  int offsets[fvens::kMaxBands];   // signed shifts s_k
  int lo[fvens::kMaxBands];        // band k is zero outside cells [lo, hi)
  int hi[fvens::kMaxBands];
};

namespace {

using fvens::kMaxBands;
using fvens::bulk_copy;
using fvens::mbar_expect_tx;
using fvens::mbar_init;
using fvens::mbar_wait;
using fvens::smem_addr;
constexpr int kThreads = 1024;
constexpr int kHeader = 16;      // dynamic shared memory before the planes
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

template <typename T>
struct Params {
  const T* dinv;
  const T* dn;
  const T* v;
  T* out;
  int nc, ld, sweeps, owned, reach, slice, cluster, ghost;
  int all_lo, all_hi;              // the cells where every band is present
  int off[kMaxBands], lo[kMaxBands], hi[kMaxBands];
};

// ---- cluster primitives (PTX; the bulk copy: bulk_copy.cuh) ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// The barrier's release half: the CTA's threads meet (bar.sync), one
// thread's fence.acq_rel.cluster then publishes every write the CTA made
// before it, its pushes into other CTAs' shared memory too (cumulatively:
// the bar.sync ordered them before the fence), and every thread arrives
// relaxed. On an NVIDIA H100 80GB HBM3 at 700 W this was faster than every
// thread arriving with release semantics (PERF.md).
__device__ __forceinline__ void cluster_arrive() {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// An arrival that publishes nothing: this CTA has started (the entry's).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared::cluster address of `addr` (this CTA's shared memory) in the
// CTA of rank `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void store_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void store_cluster(uint32_t addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;" ::"r"(addr), "d"(v)
               : "memory");
}

// Cell r0 of this CTA's slice (value y) into the ghosts of the CTAs whose
// ghost regions hold it: rank - d keeps it at r0 + d L of its buffer (its
// right ghosts, where r0 + (d - 1) L < G), rank + d at r0 - d L (its left
// ghosts, where r0 >= d L - G); buf_addr: the buffer in shared memory,
// ghosts included, at the same offset in every CTA.
template <typename T>
__device__ __forceinline__ void push_ghost(uint32_t buf_addr, int r0, T y,
                                           int rank, int L, int G, int C) {
  for (int d = 1; (d - 1) * L < G; ++d) {
    if (r0 + (d - 1) * L < G && rank - d >= 0) {
      store_cluster(map_rank(buf_addr + (G + r0 + d * L) * sizeof(T),
                             rank - d), y);
    }
    if (r0 >= d * L - G && rank + d < C) {
      store_cluster(map_rank(buf_addr + (G + r0 - d * L) * sizeof(T),
                             rank + d), y);
    }
  }
}

// The window of cluster g, [w0, w1), and the first cell of its slice 0,
// b0 (w0 rounded down to 16 bytes). The plan (bsgs_cluster_plan) does the
// same arithmetic.
struct Window {
  int w0, w1, b0, end;   // end: w1 rounded up to 16 bytes, <= ld
};

template <typename T>
__device__ __forceinline__ Window window_of(const Params<T>& p, int g) {
  constexpr int kAlign = 16 / sizeof(T);
  const int halo = p.sweeps * p.reach;
  Window w;
  w.w0 = max(0, g * p.owned - halo);
  w.w1 = min(p.nc, (g + 1) * p.owned + halo);
  w.b0 = w.w0 / kAlign * kAlign;
  w.end = (w.w1 + kAlign - 1) / kAlign * kAlign;
  return w;
}

// The cells a thread keeps the bands and D^-1 v of in registers for the
// whole apply (slice cells threadIdx.x + i * kThreads, i < kRegCells): 3 at
// up to four bands in f64 (three cells a thread cover a 512x512 slice);
// the rest read them from shared memory.
template <typename T, int K>
__host__ __device__ constexpr int reg_cells() {
  constexpr int n = (sizeof(T) == 8 ? 16 : 24) / (K + 1);
  return n < 1 ? 1 : (n > 3 ? 3 : n);
}

// One cell of a sweep: b + (-1) * sum_k (D^-1 N)_k z(c + s_k) over the bands
// present at the cell, in band order (banded_block_apply's arithmetic at
// V = 1). band[k * stride] is band k's entry (in registers or shared
// memory); z points at the cell in its buffer, whose ghosts hold the
// neighbours' values; kChecked: test each band's support (cells near the
// ends of the domain), else every band is present.
template <typename T, int K, bool kChecked>
__device__ __forceinline__ T sweep_cell(const Params<T>& p, const T* band,
                                        int stride, const T* z, T b, int c) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (kChecked && (c < p.lo[k] || c >= p.hi[k])) continue;
    acc += band[k * stride] * z[p.off[k]];
  }
  return b + T(-1) * acc;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
banded_bsgs_cluster_kernel(Params<T> p) {
  constexpr int kReg = reg_cells<T, K>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  const int L = p.slice;
  const int G = p.ghost;
  const int B = L + 2 * G;          // a buffer: G ghosts, L cells, G ghosts
  T* sband = reinterpret_cast<T*>(smem_raw + kHeader);  // (K, L)
  T* sbuf = sband + K * L;          // buffer 0: D^-1 v; 1, 2: z, in turns
  const int rank = static_cast<int>(cluster_rank());
  const int g = static_cast<int>(cluster_id());
  const int S = p.sweeps;
  const Window w = window_of(p, g);
  // this CTA's slice [s0, s1) of the window's 16-byte runs
  const int s0 = w.b0 + rank * L;
  const int s1 = min(s0 + L, w.end);
  const int len = max(0, s1 - s0);
  const int own0 = g * p.owned;
  const int own1 = min(p.nc, own0 + p.owned);

  if (S == 0) {
    // out = D^-1 v on the owned cells (the window is the owned range);
    // one band at shift 0, no base, sign +1, as banded_block_apply does
    for (int c = max(s0, own0) + threadIdx.x; c < min(s1, own1);
         c += kThreads) {
      T acc = T(0);
      acc += __ldg(p.dinv + c) * __ldg(p.v + c);
      p.out[c] = T(1) * acc;
    }
    return;
  }

  cluster_arrive_relaxed();   // this CTA has started
  if (threadIdx.x == 0 && len > 0) {
    const uint32_t bytes = len * sizeof(T);
    mbar_init(bar);
    mbar_expect_tx(bar, K * bytes);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bulk_copy(sband + k * L, p.dn + static_cast<int64_t>(k) * p.ld + s0,
                bytes, bar);
    }
  }
  // D^-1 v over the slice's window cells and its ghosts, beside the
  // copies: computed from device memory here, so no CTA waits for another's
  T* sdv = sbuf + G;
  for (int c = max(s0 - G, w.w0) + threadIdx.x; c < min(s0 + L + G, w.w1);
       c += kThreads) {
    T acc = T(0);
    acc += __ldg(p.dinv + c) * __ldg(p.v + c);
    sdv[c - s0] = T(1) * acc;
  }
  __syncthreads();                  // also: thread 0 has set up the mbarrier
  if (len > 0) mbar_wait(bar, 0);
  // every CTA of the cluster has started (the arrival at entry), so sweep
  // 1 may push into the others' shared memory
  cluster_wait();
  // the register tier (entries of cells past the slice are never used)
  T rband[kReg][K], rdv[kReg];
#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int r0 = min(static_cast<int>(threadIdx.x) + i * kThreads, L - 1);
#pragma unroll
    for (int k = 0; k < K; ++k) rband[i][k] = sband[k * L + r0];
    rdv[i] = sdv[r0];
  }

  for (int s = 1; s <= S; ++s) {
    // sweep s reads buffer s - 1, whose ghosts the other CTAs pushed
    // before the barrier (sweep 1: D^-1 v, ghosts computed here), and
    // writes buffer s, pushing its edge cells
    const T* src = sbuf + B * (s == 1 ? 0 : 1 + ((s - 1) & 1)) + G;
    T* dbuf = sbuf + B * (1 + (s & 1));
    const uint32_t dbuf_addr = smem_addr(dbuf);
    const int shrink = (S - s) * p.reach;
    const int a = max(s0, max(w.w0, own0 - shrink)) - s0;
    const int e = min(s1, min(w.w1, own1 + shrink)) - s0;
    auto put = [&](int r0, int c, T y) {
      if (s < S) {
        dbuf[G + r0] = y;
        push_ghost(dbuf_addr, r0, y, rank, L, G, p.cluster);
      } else {
        p.out[c] = y;
      }
    };
#pragma unroll
    for (int i = 0; i < kReg; ++i) {
      const int r0 = threadIdx.x + i * kThreads;
      if (r0 < a || r0 >= e) continue;
      const int c = s0 + r0;
      put(r0, c, (c >= p.all_lo && c < p.all_hi)
          ? sweep_cell<T, K, false>(p, rband[i], 1, src + r0, rdv[i], c)
          : sweep_cell<T, K, true>(p, rband[i], 1, src + r0, rdv[i], c));
    }
    int r0 = threadIdx.x + kReg * kThreads;
    if (r0 < a) r0 += (a - r0 + kThreads - 1) / kThreads * kThreads;
    for (; r0 < e; r0 += kThreads) {
      const int c = s0 + r0;
      put(r0, c, (c >= p.all_lo && c < p.all_hi)
          ? sweep_cell<T, K, false>(p, sband + r0, L, src + r0, sdv[r0], c)
          : sweep_cell<T, K, true>(p, sband + r0, L, src + r0, sdv[r0], c));
    }
    // orders sweep s's writes and pushes before sweep s + 1's reads, and
    // sweep s's reads of buffer s - 1 before sweep s + 1 writes and pushes
    // into it. Sweep S pushes nothing, so no CTA's shared memory is
    // accessed by another after the barrier that precedes it
    if (s < S) {
      cluster_arrive();
      cluster_wait();
    }
  }
}

int fail(cudaError_t err) {
  cudaGetLastError();                 // clear a non-sticky launch error
  return static_cast<int>(err);
}

template <typename T, int K>
int launch_bands(const BsgsClusterArgs* a, const void* v, void* out,
                 void* stream) {
  constexpr int kAlign = 16 / sizeof(T);
  const int C = a->cluster;
  bool bands_ok = true;
  int reach = 0;
  for (int k = 0; k < K; ++k) {
    const int s = a->offsets[k], lo = a->lo[k], hi = a->hi[k];
    bands_ok = bands_ok && 0 <= lo && lo <= hi && hi <= a->nc &&
               (lo == hi || (lo + s >= 0 && hi - 1 + s < a->nc));
    reach = std::max(reach, std::abs(s));
  }
  const int64_t halo = static_cast<int64_t>(a->sweeps) * a->reach;
  // the ghosts on either side of a slice: the reach in 16-byte runs
  const int ghost = (a->reach + kAlign - 1) / kAlign * kAlign;
  const int64_t need =
      kHeader + (static_cast<int64_t>(K) * a->slice +
                 3 * (static_cast<int64_t>(a->slice) + 2 * ghost)) *
                    sizeof(T);
  bool ok = bands_ok && a->nc >= 1 && a->sweeps >= 0 && a->reach == reach &&
            (C == 1 || C == 2 || C == 4 || C == 8 || C == kMaxCluster) &&
            a->clusters >= 1 && a->owned >= 1 &&
            static_cast<int64_t>(a->clusters) * a->owned >= a->nc &&
            static_cast<int64_t>(a->clusters - 1) * a->owned < a->nc &&
            a->slice >= kAlign && a->slice % kAlign == 0 &&
            a->ld >= a->nc && a->ld % kAlign == 0 &&
            a->smem_bytes >= need &&
            reinterpret_cast<uintptr_t>(a->dn) % 16 == 0 &&
            static_cast<int64_t>(a->clusters) * C <= (1ll << 31) - 1 &&
            halo + static_cast<int64_t>(a->clusters) * a->owned <
                (1ll << 30) &&
            a->device >= 0 && a->device < kMaxDevices;
  // every window's 16-byte runs fit in its C slices
  for (int g = 0; ok && g < a->clusters; ++g) {
    const int64_t w0 = std::max<int64_t>(0, int64_t(g) * a->owned - halo);
    const int64_t w1 =
        std::min<int64_t>(a->nc, int64_t(g + 1) * a->owned + halo);
    const int64_t span = (w1 + kAlign - 1) / kAlign * kAlign -
                         w0 / kAlign * kAlign;
    ok = span <= static_cast<int64_t>(C) * a->slice;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a->device) {
    err = cudaSetDevice(a->device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kernel = banded_bsgs_cluster_kernel<T, K>;
  static int smem_set[kMaxDevices] = {};     // the attributes, per device
  static bool wide_set[kMaxDevices] = {};
  if (a->smem_bytes > smem_set[a->device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               a->smem_bytes);
    if (err != cudaSuccess) return fail(err);
    smem_set[a->device] = a->smem_bytes;
  }
  if (C > 8 && !wide_set[a->device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return fail(err);
    wide_set[a->device] = true;
  }

  Params<T> p;
  p.dinv = static_cast<const T*>(a->dinv);
  p.dn = static_cast<const T*>(a->dn);
  p.v = static_cast<const T*>(v);
  p.out = static_cast<T*>(out);
  p.nc = a->nc;
  p.ld = a->ld;
  p.sweeps = a->sweeps;
  p.owned = a->owned;
  p.reach = a->reach;
  p.slice = a->slice;
  p.cluster = C;
  p.ghost = ghost;
  p.all_lo = 0;
  p.all_hi = a->nc;
  for (int k = 0; k < kMaxBands; ++k) {
    p.off[k] = k < K ? a->offsets[k] : 0;
    p.lo[k] = k < K ? a->lo[k] : 0;
    p.hi[k] = k < K ? a->hi[k] : 0;
    if (k < K) {
      p.all_lo = std::max(p.all_lo, a->lo[k]);
      p.all_hi = std::min(p.all_hi, a->hi[k]);
    }
  }

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->clusters * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(a->smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const BsgsClusterArgs* a, const void* v, void* out, void* stream) {
  switch (a->nbands) {
    case 1: return launch_bands<T, 1>(a, v, out, stream);
    case 2: return launch_bands<T, 2>(a, v, out, stream);
    case 3: return launch_bands<T, 3>(a, v, out, stream);
    case 4: return launch_bands<T, 4>(a, v, out, stream);
    case 5: return launch_bands<T, 5>(a, v, out, stream);
    case 6: return launch_bands<T, 6>(a, v, out, stream);
    case 7: return launch_bands<T, 7>(a, v, out, stream);
    case 8: return launch_bands<T, 8>(a, v, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success); a launch that
// the runtime refuses never runs, so the caller must check it.
int fvens_banded_bsgs_cluster_v1_f32(const BsgsClusterArgs* a, const void* v,
                                     void* out, void* stream) {
  return launch<float>(a, v, out, stream);
}

int fvens_banded_bsgs_cluster_v1_f64(const BsgsClusterArgs* a, const void* v,
                                     void* out, void* stream) {
  return launch<double>(a, v, out, stream);
}

// What the plan needs of the card: out[0] the dynamic shared memory a block
// may opt in to, out[1] the kernel's threads per block, out[2] the bytes of
// dynamic shared memory before the planes, out[3..7] the clusters of
// C = 1, 2, 4, 8, 16 CTAs the card holds at once with that shared memory
// per CTA (cudaOccupancyMaxActiveClusters; 0 where it takes none, or where
// it refuses clusters of 16).
int fvens_bsgs_cluster_limits(int device, int* out) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = optin;
  out[1] = kThreads;
  out[2] = kHeader;
  // the instantiation with the most registers a thread: f64, eight bands
  auto kernel = banded_bsgs_cluster_kernel<double, 8>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return fail(err);
  const bool wide = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
      cudaSuccess;
  cudaGetLastError();
  const int sizes[5] = {1, 2, 4, 8, kMaxCluster};
  for (int i = 0; i < 5; ++i) {
    out[3 + i] = 0;
    if (sizes[i] > 8 && !wide) continue;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = sizes[i];
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sizes[i]);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(optin);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess) {
      out[3 + i] = n;
    }
    cudaGetLastError();
  }
  return 0;
}

const char* fvens_bsgs_cluster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
