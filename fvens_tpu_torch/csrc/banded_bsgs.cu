// The whole banded bsgs preconditioner apply for Hopper (sm_90a) in one
// persistent launch, bound through a plain C interface.
//
// Replaces the TPU kernel `_banded_apply` / `_apply_kernel` (the JAX
// package's solver/pallas_banded.py:107) in the role that
// `make_banded_bsgs_pallas` (:193) gives it: one launch for D^-1 v and one
// per damped block-Jacobi sweep. Here one launch computes
//
//     z = D^-1 v;   `sweeps` times:  z <- D^-1 v - sum_k (D^-1 N)_k z_(c+d_k)
//
// with the cell arithmetic of banded_block.cuh, the same as banded_apply.cu's,
// so the result equals that of the seven-launch sequence value for value (the
// zero products it skips could change the sign of a zero result, no more).
// Blocks are VxV: V = 4 for the flow equations (fvens_banded_bsgs_f32/_f64),
// V = 1 for the scalar diffusion (the _v1_ entry points). What follows was
// designed and measured at V = 4; V = 1 runs the same kernel, with a row of
// a vector one scalar, only where the bands wrap or a cluster's slice does
// not fit in shared memory (or where a caller forces it): at V = 1 the
// solver takes banded_bsgs_cluster.cu, a design of its own for that shape
// (independent thread-block clusters, no phases chained through device
// memory; BsgsApply chooses once per operator).
//
// What bounds it. By bytes: each input read once and the output written
// once, over each band's support (the two O-mesh seam bands hold one ring of
// 320 cells each), is 72.1 MB at f32 for the 640x320 cylinder's 204,800
// cells and six bands, 21.5 us at 3.35 TB/s; the arithmetic (a 4x4 block
// product per band and cell, 20 MFLOP a sweep) is far below the card's
// rate. In practice two things hold it above that, measured on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md):
//   - the D^-1 N that does not fit on chip (45% of the cells' dense bands
//     at f32) comes back from L2 in every sweep, and every sweep gathers
//     six z rows per cell from L2: a later sweep takes about 9 us;
//   - the phases are chained through memory: a phase cannot start before
//     its neighbours' previous phase is visible, which costs 3.2-3.8 us per
//     phase even where the data is negligible (528 cells), with the flags
//     below as with grid barriers (3.15 us).
//
// What the design does about it:
//   - a cooperative grid of one block of 1,024 threads per SM; block b owns
//     the cells [b * chunk, (b + 1) * chunk) for the whole apply. Band k is
//     skipped at cells outside its support [lo_k, hi_k), where its blocks
//     are zero (BandedStructure.support), so the seam bands cost one ring of
//     cells; only the "dense" bands, whose support spans most cells, are
//     kept on chip;
//   - where the dense bands do not fit in half of L2 (at 640x320; at the
//     12,800-cell bench mesh they do, stay in L2 from sweep to sweep by
//     themselves, and a shared tier costs more than it saves: the plan
//     keeps none there), the first n_res cells of a block keep their dense
//     bands in shared memory, in the cell-minor layout of the bands
//     ((n_dense * V * V) planes of n_res values, so consecutive threads hit
//     consecutive banks), and
//     D^-1 v, the base of every sweep, beside them; the other cells read
//     theirs from device memory (L2 after the first sweep) and the dv
//     buffer. The plan leaves 32 KB of the SM's 256 KB of shared memory
//     and L1 to L1, where the sweeps' z gathers hit (BSGS_L1_BYTES): at
//     640x320 f32 732 of each block's 1,552 cells are resident;
//   - the shared tier arrives by TMA: at entry one thread issues each dense
//     plane of those cells (a contiguous run of n_res values, 16-byte
//     aligned: the plan rounds blocks and the tier to 16 bytes and BsgsApply
//     pads the plane stride ld) as one `cp.async.bulk` copy, completing on
//     an mbarrier. So the bands stream in while D^-1 v is computed and
//     while the block waits for its neighbours, and a thread waits for them
//     only when it reaches its first shared-tier cell. (Copying the same
//     planes with the threads' own loads before D^-1 v cost about 23 us
//     more an apply.);
//   - per-block flags in place of grid barriers: a sweep of block b reads
//     the previous phase's z at the cells (c + d_k) mod NC, owned by the
//     blocks deps(b) (the launch plan's), and overwrites the buffer that the
//     phase before that wrote. Before phase p, block b waits until every
//     block of waits(b) = deps(b) + {b' : b in deps(b')} has finished phase
//     p - 1: deps gives read-after-write; the reverse set gives
//     write-after-read, since no block can then be two phases ahead of a
//     block that reads its cells. On the 640x320 O-mesh waits(b) is the two
//     neighbouring blocks (the seam bands join the first and the last).
//     The flags count phases and are never reset: each apply raises every
//     block's flag by `sweeps`, so between applies all flags hold one value
//     F, which each block reads from its own flag at entry; block b then
//     publishes F + s when it has finished phase s - 1 and waits for F + s
//     in the blocks of waits(b). The count lives on the card, so an apply
//     captured in a CUDA graph stays right at every replay; the applies of
//     one operator must be ordered by one stream.
//     Memory ordering: the block's threads write their z; __syncthreads()
//     orders those writes before thread 0's st.release.gpu of the flag
//     (release is cumulative: it publishes what thread 0 has observed, the
//     whole block's writes through the barrier); a waiting block has one
//     thread per block of waits(b) read that flag with ld.acquire.gpu until
//     it is reached, then __syncthreads() orders each acquire before every
//     thread's loads of the neighbours' z (the pattern of cooperative
//     groups' grid barrier, for a few blocks instead of all). The launch
//     stays cooperative, so every block is resident and the spinning cannot
//     deadlock. (With grid barriers in place of the flags an apply took
//     2.4 us more at 640x320.);
//   - at V = 4 z rows and the base are read, and rows written, as one
//     16-byte vector (two at f64): the buffers are the kernel's own and
//     aligned. (The input v, which may be any row of the caller's, is read
//     by scalars; at V = 1 a row is one scalar, 4 or 8 bytes.);
//   - the band count K is a template argument, so the band loop unrolls and
//     a cell's loads of all its bands can be in flight together.
// Buffers: phase 0 writes dv; sweep s reads the previous z (dv for s = 1)
// and writes `out` when S - s is even, else the scratch z, so the last sweep
// lands in `out`; with no sweeps, phase 0 writes `out`.
//
// Tried on the card and left out (PERF.md): a register tier (512
// threads of 128 registers, each holding one cell's four dense bands, so
// 1,364 of 1,552 cells on chip) was as fast or slower, its first phase
// slower; an L2 prefetch of the rest tier's bands at entry was slower at
// f64 and no faster at f32; updating each sweep's cells whose neighbours
// lie in their own block before waiting for the other blocks, and walking
// a thread's cells from the last, were slower.
//
// A grid that does not fit on the card at once is refused by the runtime
// (cudaErrorCooperativeLaunchTooLarge), as is shared memory beyond the
// card's, and the error is returned: there is no fallback.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "banded_block.cuh"
#include "bulk_copy.cuh"

// Mirrors the ctypes Structure `BsgsArgs` in solver/banded_kernels.py.
struct BsgsArgs {
  const void* dinv;    // (1, V, V, nc) D^-1, cells minor
  const void* dn;      // (K, V, V, ld) D^-1 N, cells minor, plane stride ld
  void* dv;            // (nc, V) scratch: D^-1 v
  void* z;             // (nc, V) scratch: every other sweep's z
  unsigned long long* flags;  // (blocks,) the phases each block finished,
                              // zeros before the operator's first apply
  const int* waits;    // waits[b]..waits[b+1]: where block b's list lies in
                       // this same array (blocks + 1 offsets, then lists)
  int device;
  int nc;
  int ld;              // plane stride of dn, >= nc
  int nbands;
  int sweeps;
  int blocks;          // grid size; blocks * chunk >= nc
  int chunk;           // cells per block
  int n_res;           // first cells of a block: dense bands in shared
                       // memory
  int smem_bytes;      // dynamic shared memory per block
  int dense;           // bit k: band k kept on chip
  int offsets[fvens::kMaxBands];
  int lo[fvens::kMaxBands];   // band k is zero outside cells [lo, hi)
  int hi[fvens::kMaxBands];
};

namespace {

using fvens::kMaxBands;
using fvens::Offsets;
using fvens::bulk_copy;
using fvens::mbar_expect_tx;
using fvens::mbar_init;
using fvens::mbar_wait;
using fvens::smem_addr;
// One block of 1,024 threads per SM (64 registers a thread), so that a
// block gets all of its SM's shared memory.
constexpr int kThreads = 1024;
constexpr int kHeader = 16;      // dynamic shared memory before the planes
constexpr int kMaxDevices = 64;

template <typename T>
struct Params {
  const T* dinv;
  const T* dn;
  const T* v;
  T* dv;
  T* z;
  T* out;
  unsigned long long* flags;
  const int* waits;
  int nc, ld, sweeps, chunk, n_res;
  unsigned dense;
  Offsets off;
  int lo[kMaxBands], hi[kMaxBands];
};

// ---- memory-ordering primitives (PTX; the bulk copy: bulk_copy.cuh) ----

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// ---- rows of the (nc, V) vectors: at V = 4 one 16-byte access (two at
// f64), at V = 1 one scalar (a 16-byte access there would be misaligned
// and reach into the next cells) ----

template <typename T, int V>
struct LoadRowVector {
  __device__ __forceinline__ void row(const T* p, T* v) const {
    if constexpr (V == 4 && std::is_same_v<T, float>) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else if constexpr (V == 4) {
      const double2 a = reinterpret_cast<const double2*>(p)[0];
      const double2 b = reinterpret_cast<const double2*>(p)[1];
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = p[j];
    }
  }
};

template <int V, typename T>
__device__ __forceinline__ void store_row(T* p, const T* y) {
  if constexpr (V == 4 && std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else if constexpr (V == 4) {
    reinterpret_cast<double2*>(p)[0] = make_double2(y[0], y[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(y[2], y[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = y[i];
  }
}

// Where a sweep reads the band entries of one cell: from device memory
// (kGlobal), or the dense bands from shared memory and the others from
// device memory (kShared). Shared memory holds the dense bands only, in band
// order, as (n_dense * V * V) planes of n_res cells. Bands absent at the cell
// (outside their support) are skipped.
enum BandSource { kGlobal, kShared };

template <typename T, int V, BandSource kSource>
struct SweepBands {
  const T* g;          // D^-1 N at this cell, plane stride gs
  int64_t gs;
  const T* s;          // shared planes at this cell, plane stride ss
  int64_t ss;
  unsigned present;    // bit k: the cell lies in band k's support
  unsigned dense;      // bit k: band k is kept on chip
  __device__ __forceinline__ bool has(int k) const {
    return (present >> k) & 1u;
  }
  __device__ __forceinline__ T operator()(int q) const {
    const int k = q / (V * V);
    if (kSource == kShared && ((dense >> k) & 1u)) {
      return s[(__popc(dense & ((1u << k) - 1u)) * V * V + q % (V * V)) * ss];
    }
    return __ldg(g + q * gs);
  }
};

// K, the band count, is a template argument so that the band loop unrolls
// and each cell's loads of all its bands can be in flight together; V, the
// block size, so that a cell's rows and blocks are registers.
template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads, 1)
banded_bsgs_kernel(Params<T> p) {
  using fvens::banded_block_apply;
  using fvens::Planes;
  using Load = fvens::LoadReadOnly<T, V>;
  constexpr int kAlign = 16 / sizeof(T);      // cells in 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  const int64_t nr = p.n_res;
  const int64_t ld = p.ld;
  const int n_dense = __popc(p.dense);
  T* sband = reinterpret_cast<T*>(smem_raw + kHeader);  // (n_dense*V*V, nr)
  T* sbase = sband + n_dense * V * V * nr;               // (V, nr)
  const int blk = blockIdx.x;
  const int c0 = blk * p.chunk;
  const int len = max(0, min(p.chunk, p.nc - c0));
  // this block's shared tier [0, n_sh), whole 16-byte runs (the last
  // block's may reach into the planes' padding, which no cell reads)
  const int n_sh = min(p.n_res, (len + kAlign - 1) / kAlign * kAlign);
  const int sweeps = p.sweeps;
  const bool tma = sweeps > 0 && n_sh > 0;
  const Offsets zero{};
  // the phases finished before this apply, the same in every block's flag;
  // read before thread 0 first raises this block's (after a __syncthreads)
  const unsigned long long done = sweeps > 0 ? p.flags[blk] : 0;

  if (tma && threadIdx.x == 0) {
    const uint32_t bytes = n_sh * sizeof(T);
    mbar_init(bar);
    mbar_expect_tx(bar, n_dense * V * V * bytes);
    const T* src = p.dn + c0;
    int m = 0;
    for (int k = 0; k < K; ++k) {
      if (!((p.dense >> k) & 1u)) continue;
      for (int e = 0; e < V * V; ++e, ++m) {
        bulk_copy(sband + m * nr, src + (k * V * V + e) * ld, bytes, bar);
      }
    }
  }
  // phase 0: D^-1 v (one band at shift 0, no base, sign +1)
  T* first = sweeps == 0 ? p.out : p.dv;
  for (int r = threadIdx.x; r < len; r += kThreads) {
    const int c = c0 + r;
    T y[V];
    banded_block_apply<T, V, 1>(Planes<T, Load>{p.dinv + c, p.nc}, p.v, p.nc,
                                c, 1, zero, nullptr, T(1), Load(), y);
    store_row<V>(first + static_cast<int64_t>(c) * V, y);
    if (r < n_sh) {
#pragma unroll
      for (int i = 0; i < V; ++i) sbase[i * nr + r] = y[i];
    }
  }
  if (sweeps == 0) return;

  // the blocks this one waits for before each phase (at most 6K, so each
  // is one thread's)
  const int w0 = p.waits[blk];
  const int n_waits = p.waits[blk + 1] - w0;
  const unsigned long long* wflag =
      threadIdx.x < n_waits ? p.flags + p.waits[w0 + threadIdx.x] : nullptr;

  // the sweeps (base D^-1 v, sign -1: b + (-1) * acc is b - acc exactly,
  // with or without a multiply-add, as in banded_apply.cu)
  bool arrived = !tma;
  const T* src = p.dv;
  for (int s = 1; s <= sweeps; ++s) {
    // phase s - 1 is done here: publish it, and wait for it in the blocks
    // of waits(b)
    __syncthreads();
    if (threadIdx.x == 0) store_release(p.flags + blk, done + s);
    if (wflag != nullptr) {
      while (load_acquire(wflag) < done + s) {
      }
    }
    __syncthreads();
    T* dst = ((sweeps - s) % 2 == 0) ? p.out : p.z;
    for (int r = threadIdx.x; r < len; r += kThreads) {
      const int c = c0 + r;
      unsigned present = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (c >= p.lo[k] && c < p.hi[k]) present |= 1u << k;
      }
      T b[V], y[V];
      if (r < n_sh) {
        if (!arrived) {              // the TMA copies, once, in sweep 1
          mbar_wait(bar, 0);
          arrived = true;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) b[i] = sbase[i * nr + r];
        banded_block_apply<T, V, K>(
            SweepBands<T, V, kShared>{p.dn + c, ld, sband + r, nr, present,
                                      p.dense},
            src, p.nc, c, K, p.off, b, T(-1), LoadRowVector<T, V>(), y);
      } else {
        LoadRowVector<T, V>().row(p.dv + static_cast<int64_t>(c) * V, b);
        banded_block_apply<T, V, K>(
            SweepBands<T, V, kGlobal>{p.dn + c, ld, nullptr, 0, present,
                                      p.dense},
            src, p.nc, c, K, p.off, b, T(-1), LoadRowVector<T, V>(), y);
      }
      store_row<V>(dst + static_cast<int64_t>(c) * V, y);
    }
    src = dst;
  }
}

int fail(cudaError_t err) {
  cudaGetLastError();                 // clear a non-sticky launch error
  return static_cast<int>(err);
}

template <typename T, int V, int K>
int launch_bands(const BsgsArgs* a, const void* v, void* out,
                 void* stream) {
  constexpr int kAlign = 16 / sizeof(T);
  const unsigned dense = static_cast<unsigned>(a->dense);
  const int64_t per_cell =
      static_cast<int64_t>(__builtin_popcount(dense) * V * V + V) *
      sizeof(T);
  bool supports_ok = true;
  for (int k = 0; k < a->nbands && k < kMaxBands; ++k) {
    supports_ok = supports_ok && 0 <= a->lo[k] && a->lo[k] <= a->hi[k] &&
                  a->hi[k] <= a->nc;
  }
  const bool tier_ok =
      a->n_res >= 0 && a->n_res <= a->chunk &&
      (a->n_res == 0 ||
       (kHeader + a->n_res * per_cell <= a->smem_bytes &&
        a->n_res % kAlign == 0 && a->chunk % kAlign == 0 &&
        a->ld % kAlign == 0 &&
        reinterpret_cast<uintptr_t>(a->dn) % 16 == 0));
  if (a->nbands < 1 || a->nbands > kMaxBands || a->nc < 1 || !supports_ok ||
      (dense >> a->nbands) != 0u || a->ld < a->nc ||
      a->sweeps < 0 || a->blocks < 1 || a->chunk < 1 || !tier_ok ||
      a->smem_bytes < 0 ||
      static_cast<int64_t>(a->blocks) * a->chunk < a->nc ||
      (a->sweeps > 0 && (a->flags == nullptr || a->waits == nullptr)) ||
      reinterpret_cast<uintptr_t>(a->dv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a->z) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      a->device < 0 || a->device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a->device) err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kernel = banded_bsgs_kernel<T, V, K>;
  static int smem_set[kMaxDevices] = {};   // the attribute, per device
  if (a->smem_bytes > smem_set[a->device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               a->smem_bytes);
    if (err != cudaSuccess) return fail(err);
    smem_set[a->device] = a->smem_bytes;
  }

  Params<T> p;
  p.dinv = static_cast<const T*>(a->dinv);
  p.dn = static_cast<const T*>(a->dn);
  p.v = static_cast<const T*>(v);
  p.dv = static_cast<T*>(a->dv);
  p.z = static_cast<T*>(a->z);
  p.out = static_cast<T*>(out);
  p.flags = a->flags;
  p.waits = a->waits;
  p.nc = a->nc;
  p.ld = a->ld;
  p.sweeps = a->sweeps;
  p.chunk = a->chunk;
  p.n_res = a->n_res;
  p.dense = dense;
  for (int k = 0; k < kMaxBands; ++k) {
    p.off.d[k] = k < a->nbands ? a->offsets[k] : 0;
    p.lo[k] = k < a->nbands ? a->lo[k] : 0;
    p.hi[k] = k < a->nbands ? a->hi[k] : 0;
  }

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(a->smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return fail(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch(const BsgsArgs* a, const void* v, void* out, void* stream) {
  switch (a->nbands) {
    case 1: return launch_bands<T, V, 1>(a, v, out, stream);
    case 2: return launch_bands<T, V, 2>(a, v, out, stream);
    case 3: return launch_bands<T, V, 3>(a, v, out, stream);
    case 4: return launch_bands<T, V, 4>(a, v, out, stream);
    case 5: return launch_bands<T, V, 5>(a, v, out, stream);
    case 6: return launch_bands<T, V, 6>(a, v, out, stream);
    case 7: return launch_bands<T, V, 7>(a, v, out, stream);
    case 8: return launch_bands<T, V, 8>(a, v, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success); a launch that
// the runtime refuses never runs, so the caller must check it.
// 4x4 blocks.
int fvens_banded_bsgs_f32(const BsgsArgs* a, const void* v, void* out,
                          void* stream) {
  return launch<float, 4>(a, v, out, stream);
}

int fvens_banded_bsgs_f64(const BsgsArgs* a, const void* v, void* out,
                          void* stream) {
  return launch<double, 4>(a, v, out, stream);
}

// 1x1 blocks.
int fvens_banded_bsgs_v1_f32(const BsgsArgs* a, const void* v, void* out,
                             void* stream) {
  return launch<float, 1>(a, v, out, stream);
}

int fvens_banded_bsgs_v1_f64(const BsgsArgs* a, const void* v, void* out,
                             void* stream) {
  return launch<double, 1>(a, v, out, stream);
}

// What the launch plan needs of the card: out[0] SMs, out[1] the dynamic
// shared memory a block may opt in to, out[2] the shared memory of an SM,
// out[3] the shared memory the system reserves per block, out[4] the L2
// cache's bytes, out[5] the kernel's threads per block, out[6] the bytes of
// dynamic shared memory before the planes.
int fvens_bsgs_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[5] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock, cudaDevAttrL2CacheSize};
  for (int i = 0; i < 5; ++i) {
    cudaError_t err = cudaDeviceGetAttribute(out + i, attrs[i], device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  out[5] = kThreads;
  out[6] = kHeader;
  return 0;
}

const char* fvens_bsgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
