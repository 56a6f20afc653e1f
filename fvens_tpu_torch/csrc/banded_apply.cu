// Banded block apply for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernel `_banded_apply` / `_apply_kernel` in the JAX
// package's solver/pallas_banded.py (lines 86-141). It computes, for every
// cell c of NC,
//
//     out[c, :] = base[c, :] + sign * sum_k B_k[:, :, c] . x[(c + d_k) mod NC, :]
//
// with 4x4 blocks per cell and band, K <= 8 bands. One kernel serves the
// three operators of the implicit solve's Krylov loop:
//   matvec      y = D x + sum_k B_k x_(+d_k)   (D is the d = 0 band), K = 7
//   D^-1 v                                     K = 1, d = 0
//   bsgs sweep  z' = D^-1 v - sum_k (D^-1 N)_k z_(+d_k)   K = 6, sign -1
//
// Layouts: B is (K, 4, 4, NC) with cells minor (the layout banded_blocks
// builds), so thread c reads B[((k*4 + i)*4 + j)*NC + c] and a warp reads
// consecutive addresses. x, base and out are the solver's own (NC, 4)
// row-major vectors; the shifted row is found with a non-negative modulo,
// so no wrap-padded copy of x and no transposes are needed.
//
// What bounds it: per apply it streams K*16 block entries and reads 4K + 4
// vector entries per cell; at the 12,800-cell bench mesh all its operands
// (~11.5 MB in f32) sit in the 50 MB L2, so a launch is short and the
// launch latency, not HBM bandwidth, sets the pace. The design is the
// simplest right one: one thread per cell, one launch per apply. The cell's
// arithmetic is banded_block.cuh's, which the fused bsgs kernel
// (banded_bsgs.cu) shares, so the two agree to the bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "banded_block.cuh"

namespace {

using fvens::kMaxBands;
using fvens::kV;
using fvens::Offsets;
constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_apply_kernel(const T* __restrict__ B, const T* __restrict__ x,
                    const T* __restrict__ base, T* __restrict__ out,
                    int nc, int nbands, Offsets off, T sign) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= nc) return;
  T y[kV];
  fvens::banded_block_apply<T>(
      fvens::Planes<T, fvens::LoadReadOnly<T>>{B + c, nc}, x, nc, c, nbands,
      off, base == nullptr ? nullptr : base + static_cast<int64_t>(c) * kV,
      sign, fvens::LoadReadOnly<T>(), y);
  T* o = out + static_cast<int64_t>(c) * kV;
#pragma unroll
  for (int i = 0; i < kV; ++i) o[i] = y[i];
}

template <typename T>
int launch(int device, const void* B, const void* x, const void* base,
           void* out, int nc, int nbands, const int* offsets, double sign,
           void* stream) {
  if (nbands < 1 || nbands > kMaxBands || nc < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nc == 0) return 0;
  Offsets off{};
  for (int k = 0; k < nbands; ++k) off.d[k] = offsets[k];
  const int blocks = (nc + kThreads - 1) / kThreads;
  banded_apply_kernel<T><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(B), static_cast<const T*>(x),
      static_cast<const T*>(base), static_cast<T*>(out), nc, nbands, off,
      static_cast<T>(sign));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success); a launch that
// the runtime refuses never runs, so the caller must check it.
int fvens_banded_apply_f32(int device, const void* B, const void* x,
                           const void* base, void* out, int nc, int nbands,
                           const int* offsets, double sign, void* stream) {
  return launch<float>(device, B, x, base, out, nc, nbands, offsets, sign,
                       stream);
}

int fvens_banded_apply_f64(int device, const void* B, const void* x,
                           const void* base, void* out, int nc, int nbands,
                           const int* offsets, double sign, void* stream) {
  return launch<double>(device, B, x, base, out, nc, nbands, offsets, sign,
                        stream);
}

const char* fvens_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
