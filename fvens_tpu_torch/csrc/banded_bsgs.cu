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
//
// What bounds it: bytes. Each input read once and the output written once
// (D^-1, D^-1 N, v, z) is 98.3 MB at f32 for the 640x320 cylinder's 204,800
// cells and six bands, 29.3 us at 3.35 TB/s; counting each band only over
// its support (the two O-mesh seam bands hold one ring of 320 cells each),
// what this operator needs is 72.1 MB, 21.5 us. The sequence instead
// streams all 78.6 MB of D^-1 N from device memory in each of the six
// sweeps (550 MB per apply), because the bands are larger than the 50 MB L2.
//
// What the design does about it:
//   - a cooperative grid of one block of 1,024 threads per SM; block b owns
//     the cells [b * chunk, (b + 1) * chunk) for the whole apply, and a grid
//     barrier separates the phases (D^-1 v, then each sweep), which read the
//     previous phase's z of neighbouring cells;
//   - band k is skipped at cells outside its support [lo_k, hi_k), where its
//     blocks are zero (BandedStructure.support), so the seam bands cost one
//     ring of cells, and only the bands whose support spans most cells (the
//     "dense" ones) are kept in shared memory;
//   - the first sweep streams the block's slice of D^-1 N from device memory
//     and keeps the dense bands of its first n_res cells in dynamic shared
//     memory, in the cell-minor layout of the bands ((n_dense*16) planes of
//     n_res values, so consecutive threads hit consecutive banks); sweeps
//     2..S read those from shared memory and the rest from device memory.
//     At 640x320 f32 that is 854 of each block's 1,552 cells, and the rest
//     (23.6 MB) is small enough to stay in L2 from one sweep to the next;
//   - D^-1 v of the resident cells, the base of every sweep, stays in shared
//     memory too; the other cells read it back from the dv buffer;
//   - z is read with plain loads, which the L1 may cache within a phase (the
//     grid barrier orders the previous phase's writes before them); the band
//     count is a template argument, so the band loop unrolls and a cell's
//     loads of all its bands can be in flight together;
//   - the rest of the bands is read with plain loads: an L2 access-policy
//     window marking D^-1 N persisting was measured slower on the
//     cylinder's f32 operator (PERF.md) and is not used.
// Buffers: phase 0 writes dv; sweep s reads the previous z (dv for s = 1)
// and writes `out` when S - s is even, else the scratch z, so the last sweep
// lands in `out`; with no sweeps, phase 0 writes `out`.
//
// A grid that does not fit on the card at once is refused by the runtime
// (cudaErrorCooperativeLaunchTooLarge) and the error is returned: there is
// no fallback to the per-sweep launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "banded_block.cuh"

namespace cg = cooperative_groups;

// Mirrors the ctypes Structure `BsgsArgs` in solver/banded_kernels.py.
struct BsgsArgs {
  const void* dinv;    // (1, 4, 4, nc) D^-1, cells minor
  const void* dn;      // (K, 4, 4, nc) D^-1 N, cells minor
  void* dv;            // (nc, 4) scratch: D^-1 v
  void* z;             // (nc, 4) scratch: every other sweep's z
  int device;
  int nc;
  int nbands;
  int sweeps;
  int blocks;          // grid size; blocks * chunk >= nc
  int chunk;           // cells per block
  int n_res;           // cells per block whose bands stay in shared memory
  int smem_bytes;      // dynamic shared memory per block
  int dense;           // bit k: band k kept in shared memory
  int offsets[fvens::kMaxBands];
  int lo[fvens::kMaxBands];   // band k is zero outside cells [lo, hi)
  int hi[fvens::kMaxBands];
};

namespace {

using fvens::kMaxBands;
using fvens::kV;
using fvens::Offsets;
// One block of 1,024 threads per SM (64 registers a thread), so that a
// block gets all of its SM's shared memory.
constexpr int kThreads = 1024;
constexpr int kBlocksPerSM = 1;
constexpr int kMaxDevices = 64;

template <typename T>
struct Params {
  const T* dinv;
  const T* dn;
  const T* v;
  T* dv;
  T* z;
  T* out;
  int nc, sweeps, chunk, n_res;
  unsigned dense;
  Offsets off;
  int lo[kMaxBands], hi[kMaxBands];
};

// Where a sweep reads the band entries of one cell: from device memory
// (kGlobal), from device memory keeping the dense bands' entries in shared
// memory as they pass (kStash: the first sweep of a resident cell), or the
// dense bands from shared memory and the others from device memory
// (kShared). Shared memory holds the dense bands only, in band order, as
// (n_dense * 16) planes of n_res cells. Bands absent at the cell (outside
// their support) are skipped.
enum BandSource { kGlobal, kStash, kShared };

template <typename T, BandSource kSource>
struct SweepBands {
  const T* g;          // D^-1 N at this cell, plane stride gs
  int64_t gs;
  T* s;                // shared planes at this cell, plane stride ss
  int64_t ss;
  unsigned present;    // bit k: the cell lies in band k's support
  unsigned dense;      // bit k: band k is kept in shared memory
  __device__ __forceinline__ bool has(int k) const {
    return (present >> k) & 1u;
  }
  __device__ __forceinline__ T operator()(int q) const {
    const int k = q / (kV * kV);
    if (kSource != kGlobal && ((dense >> k) & 1u)) {
      T* sp = s + (__popc(dense & ((1u << k) - 1u)) * kV * kV +
                   q % (kV * kV)) * ss;
      if (kSource == kShared) return *sp;
      const T v = __ldg(g + q * gs);
      *sp = v;
      return v;
    }
    return __ldg(g + q * gs);
  }
};

// K, the band count, is a template argument so that the band loop unrolls
// and each cell's loads of all its bands can be in flight together.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
banded_bsgs_kernel(Params<T> p) {
  using fvens::banded_block_apply;
  using fvens::LoadPlain;
  using fvens::LoadReadOnly;
  using fvens::Planes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t nr = p.n_res;
  const int n_dense = __popc(p.dense);
  T* sband = reinterpret_cast<T*>(smem_raw);        // (n_dense*16, n_res)
  T* sbase = sband + n_dense * kV * kV * nr;         // (4, n_res)
  const int c0 = blockIdx.x * p.chunk;
  const int len = max(0, min(p.chunk, p.nc - c0));
  const Offsets zero{};

  // phase 0: D^-1 v (one band at shift 0, no base, sign +1)
  T* first = p.sweeps == 0 ? p.out : p.dv;
  for (int r = threadIdx.x; r < len; r += kThreads) {
    const int c = c0 + r;
    T y[kV];
    banded_block_apply<T>(Planes<T, LoadReadOnly<T>>{p.dinv + c, p.nc}, p.v,
                          p.nc, c, 1, zero, nullptr, T(1),
                          LoadReadOnly<T>(), y);
    T* o = first + static_cast<int64_t>(c) * kV;
#pragma unroll
    for (int i = 0; i < kV; ++i) o[i] = y[i];
    if (r < p.n_res) {
#pragma unroll
      for (int i = 0; i < kV; ++i) sbase[i * nr + r] = y[i];
    }
  }
  if (p.sweeps == 0) return;

  // the sweeps (base D^-1 v, sign -1: b + (-1) * acc is b - acc exactly,
  // with or without a multiply-add, as in banded_apply.cu)
  cg::grid_group grid = cg::this_grid();
  const T* src = p.dv;
  for (int s = 1; s <= p.sweeps; ++s) {
    grid.sync();
    T* dst = ((p.sweeps - s) % 2 == 0) ? p.out : p.z;
    for (int r = threadIdx.x; r < len; r += kThreads) {
      const int c = c0 + r;
      unsigned present = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (c >= p.lo[k] && c < p.hi[k]) present |= 1u << k;
      }
      T b[kV], y[kV];
      if (r < p.n_res) {
#pragma unroll
        for (int i = 0; i < kV; ++i) b[i] = sbase[i * nr + r];
        if (s == 1) {
          banded_block_apply<T>(
              SweepBands<T, kStash>{p.dn + c, p.nc, sband + r, nr, present,
                                    p.dense},
              src, p.nc, c, K, p.off, b, T(-1), LoadPlain<T>(), y);
        } else {
          banded_block_apply<T>(
              SweepBands<T, kShared>{p.dn + c, p.nc, sband + r, nr, present,
                                     p.dense},
              src, p.nc, c, K, p.off, b, T(-1), LoadPlain<T>(), y);
        }
      } else {
        const T* dvr = p.dv + static_cast<int64_t>(c) * kV;
#pragma unroll
        for (int i = 0; i < kV; ++i) b[i] = dvr[i];
        banded_block_apply<T>(
            SweepBands<T, kGlobal>{p.dn + c, p.nc, nullptr, 0, present,
                                   p.dense},
            src, p.nc, c, K, p.off, b, T(-1), LoadPlain<T>(), y);
      }
      T* o = dst + static_cast<int64_t>(c) * kV;
#pragma unroll
      for (int i = 0; i < kV; ++i) o[i] = y[i];
    }
    src = dst;
  }
}

int fail(cudaError_t err) {
  cudaGetLastError();                 // clear a non-sticky launch error
  return static_cast<int>(err);
}

template <typename T, int K>
int launch_bands(const BsgsArgs* a, const void* v, void* out,
                 void* stream) {
  const unsigned dense = static_cast<unsigned>(a->dense);
  const int64_t per_cell =
      static_cast<int64_t>(__builtin_popcount(dense) * kV * kV + kV) *
      sizeof(T);
  bool supports_ok = true;
  for (int k = 0; k < a->nbands && k < kMaxBands; ++k) {
    supports_ok = supports_ok && 0 <= a->lo[k] && a->lo[k] <= a->hi[k] &&
                  a->hi[k] <= a->nc;
  }
  if (a->nbands < 1 || a->nbands > kMaxBands || a->nc < 1 || !supports_ok ||
      (dense >> a->nbands) != 0u ||
      a->sweeps < 0 || a->blocks < 1 || a->chunk < 1 || a->n_res < 0 ||
      a->n_res > a->chunk || a->smem_bytes < 0 ||
      static_cast<int64_t>(a->blocks) * a->chunk < a->nc ||
      a->n_res * per_cell > a->smem_bytes || a->device < 0 ||
      a->device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != a->device) err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kernel = banded_bsgs_kernel<T, K>;
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
  p.nc = a->nc;
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

template <typename T>
int launch(const BsgsArgs* a, const void* v, void* out, void* stream) {
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
int fvens_banded_bsgs_f32(const BsgsArgs* a, const void* v, void* out,
                          void* stream) {
  return launch<float>(a, v, out, stream);
}

int fvens_banded_bsgs_f64(const BsgsArgs* a, const void* v, void* out,
                          void* stream) {
  return launch<double>(a, v, out, stream);
}

// What the launch plan needs of the card: out[0] SMs, out[1] the dynamic
// shared memory a block may opt in to, out[2] the shared memory of an SM,
// out[3] the shared memory the system reserves per block, out[4] the fused
// kernel's threads per block, out[5] its blocks per SM.
int fvens_bsgs_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 4; ++i) {
    cudaError_t err = cudaDeviceGetAttribute(out + i, attrs[i], device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  out[4] = kThreads;
  out[5] = kBlocksPerSM;
  return 0;
}

const char* fvens_bsgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
