// The gather path's slot contraction for Hopper (sm_90a), bound through a
// plain C interface: the block matvec and the whole bsgs preconditioner
// apply on slot gathers.
//
// Replaces no TPU kernel: the JAX package's gather path (solver/linear.py,
// bsr_matvec and make_preconditioner's bsgs) is XLA, a gather and an
// einsum, and the port ran it as PyTorch's row gather (index_select), a
// batched product (torch.bmm, cuBLAS's gemv on (NC, V, S*V) by (NC, S*V,
// 1)) and a subtraction, 19 launches from Python for bsgs x 6. Both roles
// are one contraction over S slots of V x V blocks,
//
//     y[c, i] = base[c, i] - sum_s sum_j B[c, i, s*V + j] x[idx[c, s], j]
//
// with B the (NC, V, S*V) operand of linear._slot_operand (row i of cell
// c's S blocks side by side), idx (NC, S) the rows of x that the slots
// gather (int32), and:
//   - the matvec: B the diagonal and the four neighbour blocks, slot 0
//     pointing at the cell itself (S = 5), no base, the sign +;
//   - the bsgs apply: z = D^-1 v (B = D^-1, S = 1, idx the cell itself),
//     then `sweeps` times z <- D^-1 v - (D^-1 N) z_nbr (S = 4).
// Blocks are V x V: V = 4 for the flow equations, V = 1 for the scalar
// diffusion; float32 and float64, the operator's own type throughout.
//
// What bounds it: bytes. At 640x320 (204,800 cells) in f64 the D^-1 N
// operand is 104.9 MB, more than the card's 50 MB of L2, so every sweep
// streams it from device memory; z, D^-1 v and the new z are 6.55 MB each
// and stay in L2, where the four 32-byte neighbour rows a cell gathers
// hit. The roofline (benchmark/roofline.py) counts D^-1, D^-1 N, v and z
// once: 144.2 MB, 43.0 us at 3.35 TB/s in f64 (72.1 MB, 21.5 us in f32).
// A sweep cannot reuse the operand of the last one, except what stays on
// chip, and the sweeps are chained: each gathers the z of the one before.
//
// The design (measured on an NVIDIA H100 80GB HBM3 at 700 W on the
// 640x320 NACA0012 O-mesh's operators, device time a call; PERF.md):
//   - one thread per (cell, row): it reads its row of B, S*V contiguous
//     values (128 bytes at f64, V = 4, S = 4) as 16-byte loads, so a warp
//     reads 4 KB of contiguous operand, each load instruction a 16-byte
//     piece of 32 rows that L1 keeps until the next ones use the rest of
//     their sectors; its cell's S indices as one load where they fit 16
//     bytes; the S gathered rows of x (32 bytes each), which the four
//     threads of a cell share; and writes one value, so a warp writes 256
//     contiguous bytes at f64. The matvec is one launch of this (59 us at
//     f64, 74% of its bound; 30 us at f32);
//   - the bsgs apply is ONE persistent cooperative launch: a block of 512
//     threads on each SM owns a contiguous run of rows for the whole
//     apply, runs D^-1 v and the sweeps over it, and waits at a grid
//     barrier between the phases (a phase gathers z rows that other blocks
//     wrote in the last). The first rows of each block keep their D^-1 N in
//     shared memory from the first sweep on, as planes of the block's
//     resident rows (value k of row l at k * n_res + l, so consecutive
//     threads read consecutive words), so the later sweeps stream only the
//     rest: the tier takes what an SM's 256 KB of L1 and shared memory
//     leave after the streamed rows' loads in flight (512 threads x one
//     row): 192 KB at f64 (25% of the rows), the 227 KB a block may take
//     at f32 (58%). bsgs x 6 took 0.293 ms at f64 (14.7% of its bound),
//     0.106 ms at f32; a 227 KB tier at f64 0.332 ms (L1 too small for the
//     streamed rows' loads), none 0.346;
//   - measured against it and left out: one launch per phase chained by
//     programmatic dependent launch (griddepcontrol: each sweep read its
//     operand rows and indices before waiting for the last), 0.314 ms at
//     f64 and 0.152 at f32; warp tiles whose lanes load the operand as
//     contiguous 512-byte runs and sum a row's parts by shuffles, in the
//     same persistent launch, 0.433 ms at f64 and 0.178 at f32;
//   - the gathered vector and the base are read through L2 (ld.global.cg):
//     they were written by the previous phase, on other SMs; the operand,
//     the indices and D^-1 through the read-only path;
//   - the sum runs slot by slot, column by column, as multiply-adds in the
//     operand's type, so the kernel equals the plain twin (gather, bmm,
//     subtract) to its sum order.
// Buffers: phase 0 writes dv (or `out` with no sweeps); sweep s reads the
// previous z (dv for s = 1) and writes `out` when sweeps - s is even, else
// the scratch z, so the last sweep lands in `out`.
//
// Nothing is allocated and nothing waits for the host: the launches go on
// the caller's stream and can be captured in a CUDA graph. The grid
// barrier's counter is the caller's and never reset, and the grid is the
// same at every call on a device, so the calls of one operator must be
// ordered by one stream. A grid that does not fit on the card at once is
// refused by the runtime (cudaErrorCooperativeLaunchTooLarge), and every
// refused launch is returned as its cudaError_t: there is no fallback.

#include <cuda_runtime.h>
#include <cstdint>

// Mirrors the ctypes Structure `SlotArgs` in solver/slot_kernels.py.
struct SlotArgs {
  const void* op;      // (nc, V, S*V) the blocks, row by row
  const int* idx;      // (nc, S) int32: the rows of x each slot gathers
  const void* dinv;    // (nc, V, V) D^-1 (the bsgs apply), else null
  void* dv;            // (nc, V) scratch: D^-1 v (the bsgs apply)
  void* z;             // (nc, V) scratch: every other sweep's z
  unsigned long long* counter;  // (1,) grid-barrier arrivals, zero at first
  int device;
  int nc;
  int sweeps;
};

namespace {

constexpr int kThreads = 256;        // the matvec's block
constexpr int kPThreads = 512;       // the bsgs apply's block, one an SM
constexpr int kMaxDevices = 64;
// an SM's L1 and shared memory together (Hopper): what the shared tier
// leaves of it is L1
constexpr int kL1SharedBytes = 256 * 1024;

// ---- loads of a contiguous run of N values: 16-byte accesses where they
// divide the run's bytes, so that every run of an array of such runs is
// aligned when the array is 16-byte aligned; else one value at a time ----

template <typename T, int E> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<double, 2> { using type = double2; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<int, 4> { using type = int4; };
template <> struct Vec<int, 1> { using type = int; };

__device__ __forceinline__ void put(float4 a, float* o) {
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void put(float a, float* o) { o[0] = a; }
__device__ __forceinline__ void put(double2 a, double* o) {
  o[0] = a.x; o[1] = a.y;
}
__device__ __forceinline__ void put(double a, double* o) { o[0] = a; }
__device__ __forceinline__ void put(int4 a, int* o) {
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void put(int a, int* o) { o[0] = a; }

template <typename T, int N>
__host__ __device__ constexpr int vec_elems() {
  return N * sizeof(T) % 16 == 0 ? static_cast<int>(16 / sizeof(T)) : 1;
}

// kL2: through L2 (data another SM wrote in an earlier phase), else the
// read-only path
template <typename T, int N, bool kL2>
__device__ __forceinline__ void load_run(T* out, const T* p) {
  constexpr int E = vec_elems<T, N>();
  using W = typename Vec<T, E>::type;
  const W* q = reinterpret_cast<const W*>(p);
#pragma unroll
  for (int k = 0; k < N / E; ++k) put(kL2 ? __ldcg(q + k) : __ldg(q + k),
                                      out + k * E);
}

// a row of V values of the gathered vector; `vec`: its base is aligned for
// the row's vector access (the kernel's own buffers are; a caller's v may
// not be)
template <typename T, int V>
__device__ __forceinline__ void load_x(T* out, const T* p, bool vec) {
  if (vec) {
    load_run<T, V, true>(out, p);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = __ldcg(p + j);
  }
}

// ---- the contraction of one row ----

enum Mode { kMatvec, kDinv, kSweep };

template <typename T>
struct Phase {
  const T* op;         // rows of NS*V values
  const int* idx;      // (nc, S), unused by kDinv
  const T* x;          // the gathered vector
  const T* base;       // kSweep: D^-1 v
  T* out;
  int64_t rows;        // nc * V
  int x_vec;
};

// NS slots (1 for kDinv, which gathers the cell's own row)
template <typename T, int V, int S, Mode kMode>
struct Row {
  static constexpr int NS = kMode == kDinv ? 1 : S;
  static constexpr int W = NS * V;
  T a[W];
  int nb[NS];

  // the row of the operand and the cell's indices
  __device__ __forceinline__ void fetch(const Phase<T>& p, int64_t r) {
    load_run<T, W, false>(a, p.op + r * W);
    fetch_idx(p, r);
  }
  __device__ __forceinline__ void fetch_idx(const Phase<T>& p, int64_t r) {
    const int64_t c = r / V;
    if constexpr (kMode == kDinv) {
      nb[0] = static_cast<int>(c);
    } else {
      load_run<int, S, false>(nb, p.idx + c * S);
    }
  }
  // the gathers, the sum and the store
  __device__ __forceinline__ void finish(const Phase<T>& p, int64_t r) const {
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      T xs[V];
      load_x<T, V>(xs, p.x + static_cast<int64_t>(nb[s]) * V, p.x_vec);
#pragma unroll
      for (int j = 0; j < V; ++j) acc = fma(a[s * V + j], xs[j], acc);
    }
    p.out[r] = kMode == kSweep ? __ldcg(p.base + r) - acc : acc;
  }
};

// The matvec: one thread per row
template <typename T, int V, int S>
__global__ void __launch_bounds__(kThreads)
slot_matvec_kernel(Phase<T> p) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r < p.rows) {
    Row<T, V, S, kMatvec> row;
    row.fetch(p, r);
    row.finish(p, r);
  }
}

// ---- the bsgs apply: one persistent launch ----

__device__ __forceinline__ unsigned long long atom_add_release(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.add.release.gpu.global.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Every block arrives once per barrier, and none arrives at the next
// before all have arrived at this one, so the arrivals at one barrier are
// the counts [g n, (g + 1) n) of the counter, which is never reset
// (captured in a graph, it stays right at every replay).
__device__ __forceinline__ void grid_barrier(unsigned long long* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long n = gridDim.x;
    const unsigned long long old = atom_add_release(counter, 1);
    const unsigned long long target = (old / n + 1) * n;
    while (load_acquire(counter) < target) {
    }
  }
  __syncthreads();
}

template <typename T>
struct Apply {
  Phase<T> dinv;       // phase 0
  Phase<T> sweep;      // x, out set per sweep
  T* z;
  T* out;
  unsigned long long* counter;
  int sweeps;
  int64_t chunk;       // rows per block
  int n_res;           // a block's first rows with D^-1 N in shared memory
};

template <typename T, int V, int S>
__global__ void __launch_bounds__(kPThreads, 1)
slot_bsgs_kernel(Apply<T> p) {
  using RowS = Row<T, V, S, kSweep>;
  constexpr int W = RowS::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tier = reinterpret_cast<T*>(smem_raw);   // W planes of n_res rows
  const int64_t rows = p.sweep.rows;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * p.chunk;
  const int64_t r1 = r0 + p.chunk < rows ? r0 + p.chunk : rows;
  const int nr = p.n_res;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kPThreads) {
    Row<T, V, S, kDinv> row;
    row.fetch(p.dinv, r);
    row.finish(p.dinv, r);
  }
  Phase<T> ph = p.sweep;
  for (int s = 1; s <= p.sweeps; ++s) {
    grid_barrier(p.counter);
    ph.out = ((p.sweeps - s) & 1) ? p.z : p.out;
    for (int64_t r = r0 + threadIdx.x; r < r1; r += kPThreads) {
      const int64_t l = r - r0;
      RowS row;
      if (l < nr && s > 1) {
#pragma unroll
        for (int k = 0; k < W; ++k) row.a[k] = tier[k * nr + l];
        row.fetch_idx(ph, r);
      } else {
        row.fetch(ph, r);
        if (l < nr) {
#pragma unroll
          for (int k = 0; k < W; ++k) tier[k * nr + l] = row.a[k];
        }
      }
      row.finish(ph, r);
    }
    ph.x = ph.out;
  }
}

// ---- the launches ----

int current_device(int device) {
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

int launched(cudaError_t err) {
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
bool x_aligned(const void* x) {
  constexpr int E = vec_elems<T, V>();
  return reinterpret_cast<uintptr_t>(x) % (E * sizeof(T)) == 0;
}

template <typename T, int V, int S>
int slot_matvec(const SlotArgs* a, const void* x, void* out, void* stream) {
  int err = current_device(a->device);
  if (err != 0) return err;
  if (a->nc <= 0) return 0;
  Phase<T> p;
  p.op = static_cast<const T*>(a->op);
  p.idx = a->idx;
  p.x = static_cast<const T*>(x);
  p.base = nullptr;
  p.out = static_cast<T*>(out);
  p.rows = static_cast<int64_t>(a->nc) * V;
  p.x_vec = x_aligned<T, V>(x);
  const unsigned blocks = static_cast<unsigned>((p.rows + kThreads - 1) /
                                                kThreads);
  slot_matvec_kernel<T, V, S><<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return launched(cudaSuccess);
}

// The grid and the shared tier of the bsgs kernel on a device, planned at
// its first call there: one block an SM, the tier kL1SharedBytes less the
// streamed rows' loads in flight, at most what a block may take
struct Plan {
  int blocks = 0;
  int smem = 0;
};

template <typename T, int V, int S>
int bsgs_plan(int device, Plan* out) {
  static Plan plans[kMaxDevices];
  Plan& pl = plans[device];
  if (pl.blocks == 0) {
    auto kernel = slot_bsgs_kernel<T, V, S>;
    int sms = 0, optin = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int in_flight = kPThreads * S * V * static_cast<int>(sizeof(T));
    int smem = kL1SharedBytes - in_flight;
    if (smem > optin) smem = optin;
    if (smem < 0) smem = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kPThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    pl.smem = smem;
    pl.blocks = sms;
  }
  *out = pl;
  return 0;
}

template <typename T, int V, int S>
int slot_bsgs(const SlotArgs* a, const void* v, void* out, void* stream) {
  int err = current_device(a->device);
  if (err != 0) return err;
  if (a->nc <= 0) return 0;
  if (a->sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  err = bsgs_plan<T, V, S>(a->device, &pl);
  if (err != 0) return err;
  const int64_t rows = static_cast<int64_t>(a->nc) * V;
  T* o = static_cast<T*>(out);

  Apply<T> p;
  p.dinv.op = static_cast<const T*>(a->dinv);
  p.dinv.idx = nullptr;
  p.dinv.x = static_cast<const T*>(v);
  p.dinv.base = nullptr;
  p.dinv.out = a->sweeps == 0 ? o : static_cast<T*>(a->dv);
  p.dinv.rows = rows;
  p.dinv.x_vec = x_aligned<T, V>(v);
  p.sweep.op = static_cast<const T*>(a->op);
  p.sweep.idx = a->idx;
  p.sweep.x = static_cast<T*>(a->dv);
  p.sweep.base = static_cast<T*>(a->dv);
  p.sweep.out = o;
  p.sweep.rows = rows;
  p.sweep.x_vec = 1;                   // dv and z: the caller's aligned
  p.z = static_cast<T*>(a->z);
  p.out = o;
  p.counter = a->counter;
  p.sweeps = a->sweeps;
  p.chunk = (rows + pl.blocks - 1) / pl.blocks;
  const int64_t fit = pl.smem / (S * V * static_cast<int>(sizeof(T)));
  p.n_res = static_cast<int>(fit < p.chunk ? fit : p.chunk);

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks);
  cfg.blockDim = dim3(kPThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(pl.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return launched(cudaLaunchKernelEx(&cfg, slot_bsgs_kernel<T, V, S>, p));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launches (0 on success); a launch
// that the runtime refuses never runs, so the caller must check it.
// The matvec, five slots (the cell itself first).
int fvens_slot_matvec_v4_f32(const SlotArgs* a, const void* x, void* out,
                             void* stream) {
  return slot_matvec<float, 4, 5>(a, x, out, stream);
}
int fvens_slot_matvec_v4_f64(const SlotArgs* a, const void* x, void* out,
                             void* stream) {
  return slot_matvec<double, 4, 5>(a, x, out, stream);
}
int fvens_slot_matvec_v1_f32(const SlotArgs* a, const void* x, void* out,
                             void* stream) {
  return slot_matvec<float, 1, 5>(a, x, out, stream);
}
int fvens_slot_matvec_v1_f64(const SlotArgs* a, const void* x, void* out,
                             void* stream) {
  return slot_matvec<double, 1, 5>(a, x, out, stream);
}

// The bsgs apply, four neighbour slots.
int fvens_slot_bsgs_v4_f32(const SlotArgs* a, const void* v, void* out,
                           void* stream) {
  return slot_bsgs<float, 4, 4>(a, v, out, stream);
}
int fvens_slot_bsgs_v4_f64(const SlotArgs* a, const void* v, void* out,
                           void* stream) {
  return slot_bsgs<double, 4, 4>(a, v, out, stream);
}
int fvens_slot_bsgs_v1_f32(const SlotArgs* a, const void* v, void* out,
                           void* stream) {
  return slot_bsgs<float, 1, 4>(a, v, out, stream);
}
int fvens_slot_bsgs_v1_f64(const SlotArgs* a, const void* v, void* out,
                           void* stream) {
  return slot_bsgs<double, 1, 4>(a, v, out, stream);
}

const char* fvens_slot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
