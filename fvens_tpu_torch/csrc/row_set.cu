// Basis row append of blocked GMRES for Hopper (sm_90a), bound through a
// plain C interface.
//
// Replaces the TPU kernel `row_set` / `_row_set_kernel` in the JAX package's
// solver/pallas_banded.py (lines 227-286), fused with the scale its caller
// applies first (solver/linear.py:478, `V = _basis_row_set(V, w / max(hn,
// tiny), j + 1)`). In one pass over the row it computes
//
//     row[i] = w[i] / max(hn, tiny)        for every i < n
//
// where `row` points at row j of the (mpad, n) Krylov basis, which is
// written in place, and `hn` is the norm of w, read from device memory so
// the host never waits for it. tiny is 1e-300 at f64 and 0 at f32 (the
// f32 rounding of 1e-300), the max propagates a NaN norm as
// torch.clamp_min does, and the division is a true IEEE division
// (__fdiv_rn / __ddiv_rn, never a multiply by the reciprocal), so the
// kernel equals its plain PyTorch twin bit for bit.
//
// What bounds it: one read of w and one write of the row, 8 bytes per
// element at f32 (6.6 MB at n = 819,200), so memory bandwidth; at that
// size a launch moves about two microseconds' worth of HBM traffic, so the
// fixed cost of a launch weighs as much as the streaming. What is not
// carried over: the TPU kernel's 8-row panel read-modify-write and its
// lane-tile gate, which exist because a TPU DMA slice must be
// (8, 128)-aligned in its tiled HBM layout. Here the row is contiguous, so
// the kernel touches only row j, for any n and any row stride (the caller
// passes the row's own address).
//
// The design for the card:
//   - the grid is sized to the card, not to n: at most kBlocksPerSM blocks
//     per SM (the SM count is read once per device), each streaming one
//     contiguous chunk of the row, so the launch is one wave of block
//     dispatch at every n, spread over as many SMs as the row fills;
//   - 16-byte accesses (float4 / double2), up to kUnroll of them in flight
//     per thread before the divisions;
//   - a row of an (mpad, n) basis with n not a multiple of the vector width
//     starts off a 16-byte boundary: the first `head` elements (up to the
//     boundary) and the last `n - head` mod width are peeled off and done
//     with scalar accesses by the first block, inside the same kernel. When
//     w's alignment differs from the row's, w is read with scalar loads
//     and the row is still written 16 bytes at a time.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr int kBlocksPerSM = 4;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
  static __device__ __forceinline__ float4 load(const float* p, bool aligned) {
    if (aligned) return __ldg(reinterpret_cast<const float4*>(p));
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  static __device__ __forceinline__ float4 div(float4 a, float d) {
    return make_float4(div_rn(a.x, d), div_rn(a.y, d), div_rn(a.z, d),
                       div_rn(a.w, d));
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
  static __device__ __forceinline__ double2 load(const double* p,
                                                 bool aligned) {
    if (aligned) return __ldg(reinterpret_cast<const double2*>(p));
    return make_double2(__ldg(p), __ldg(p + 1));
  }
  static __device__ __forceinline__ double2 div(double2 a, double d) {
    return make_double2(div_rn(a.x, d), div_rn(a.y, d));
  }
};

// The row is row[0, head) scalar, then nvec vectors of Vec<T>::width
// elements, then the scalar tail up to n; block b streams the vectors
// [b * chunk, (b + 1) * chunk), chunk a multiple of kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_set_kernel(T* __restrict__ row, const T* __restrict__ w,
               const T* __restrict__ hn, int64_t n, int head, int64_t nvec,
               int w_aligned, int64_t chunk, T tiny) {
  using V = Vec<T>;
  using VT = typename V::type;
  const T h = __ldg(hn);
  const T d = (h < tiny) ? tiny : h;       // a NaN norm stays NaN
  if (blockIdx.x == 0) {
    const int64_t tail = static_cast<int64_t>(head) + nvec * V::width;
    const int i = static_cast<int>(threadIdx.x);
    if (i < head) row[i] = div_rn(__ldg(w + i), d);
    if (tail + i < n) row[tail + i] = div_rn(__ldg(w + tail + i), d);
  }
  VT* __restrict__ rv = reinterpret_cast<VT*>(row + head);
  const T* __restrict__ wb = w + head;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = first + chunk < nvec ? first + chunk : nvec;
  for (int64_t base = first + threadIdx.x; base < end;
       base += kThreads * kUnroll) {
    VT x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < end) x[u] = V::load(wb + i * V::width, w_aligned);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < end) rv[i] = V::div(x[u], d);
    }
  }
}

template <typename T>
int launch(int device, void* row, const void* w, const void* hn, int64_t n,
           double tiny, void* stream) {
  const uintptr_t ra = reinterpret_cast<uintptr_t>(row);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  if (n < 0 || device < 0 || device >= kMaxDevices || ra % sizeof(T) != 0 ||
      wa % sizeof(T) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  static int sms[kMaxDevices] = {};        // SMs per device, read once
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  constexpr int width = Vec<T>::width;
  int64_t head = static_cast<int64_t>((16 - ra % 16) % 16 / sizeof(T));
  if (head > n) head = n;
  const int64_t nvec = (n - head) / width;
  const int w_aligned = (wa + head * sizeof(T)) % 16 == 0;
  // one vector a thread at least, at most kBlocksPerSM blocks per SM; a
  // block's chunk a whole number of kThreads vectors
  const int64_t max_blocks = static_cast<int64_t>(sms[device]) * kBlocksPerSM;
  int64_t blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  int64_t chunk = (nvec + blocks - 1) / blocks;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  if (chunk > 0) blocks = (nvec + chunk - 1) / chunk;
  if (blocks < 1) blocks = 1;
  row_set_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(row), static_cast<const T*>(w),
      static_cast<const T*>(hn), n, static_cast<int>(head), nvec, w_aligned,
      chunk, static_cast<T>(tiny));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success); a launch that
// the runtime refuses never runs, so the caller must check it.
int fvens_row_set_f32(int device, void* row, const void* w, const void* hn,
                      int64_t n, double tiny, void* stream) {
  return launch<float>(device, row, w, hn, n, tiny, stream);
}

int fvens_row_set_f64(int device, void* row, const void* w, const void* hn,
                      int64_t n, double tiny, void* stream) {
  return launch<double>(device, row, w, hn, n, tiny, stream);
}

const char* fvens_row_set_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
