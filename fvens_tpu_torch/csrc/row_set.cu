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
// element at f32 (6.6 MB at n = 819,200), so HBM bandwidth; a few
// microseconds a launch. What is not carried over: the TPU kernel's 8-row
// panel read-modify-write and its lane-tile gate, which exist because a
// TPU DMA slice must be (8, 128)-aligned in its tiled HBM layout. Here the
// row is contiguous, so the kernel touches only row j, for any n and any
// row stride (the caller passes the row's own address). A grid-stride
// loop, one element per thread per trip.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_set_kernel(T* __restrict__ row, const T* __restrict__ w,
               const T* __restrict__ hn, int64_t n, T tiny) {
  const T h = __ldg(hn);
  const T d = (h < tiny) ? tiny : h;       // a NaN norm stays NaN
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    row[i] = div_rn(__ldg(w + i), d);
  }
}

template <typename T>
int launch(int device, void* row, const void* w, const void* hn, int64_t n,
           double tiny, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  row_set_kernel<T><<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(row), static_cast<const T*>(w),
      static_cast<const T*>(hn), n, static_cast<T>(tiny));
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
