// One cell of the banded block apply, shared by banded_apply.cu and
// banded_bsgs.cu so that the two kernels do the same arithmetic in the same
// order, with the same multiply-add contraction:
//
//     y[i] = base[i] + sign * sum_k sum_j B_k[i, j, c] * x[(c + d_k) mod NC, j]
//
// (y[i] = sign * acc[i] without a base). The band entries come through an
// accessor `band(q)`, q = (k * V + i) * V + j, so a caller can read them from
// device memory or from shared memory; `ldx.row` loads the V entries of a
// row of x, one at a time or as one vector. Neither changes a value,
// so every caller gets the same y to the bit. `band.has(k)` false skips band
// k, whose blocks the caller knows to be zero at this cell: adding its
// products would change acc by a signed zero at most.
//
// The block size V is a template argument: 4 for the flow equations' 4x4
// blocks (NVARS), 1 for the scalar diffusion's 1x1 blocks; both kernels are
// instantiated for the two. The sum per output row runs over the bands in
// order k, then the columns j, whatever V is.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace fvens {

constexpr int kMaxBands = 8;

struct Offsets {
  int d[kMaxBands];
};

// Loads of a tensor that no thread writes during the kernel (read-only path):
// one entry, or the V entries of a row.
template <typename T, int V>
struct LoadReadOnly {
  __device__ __forceinline__ T operator()(const T* p) const { return __ldg(p); }
  __device__ __forceinline__ void row(const T* p, T* v) const {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __ldg(p + j);
  }
};

// Band entries of one cell in a planar (K*V*V, n) layout: entry q at
// p[q * stride]; every band is present.
template <typename T, typename Load>
struct Planes {
  const T* p;
  int64_t stride;
  __device__ __forceinline__ bool has(int) const { return true; }
  __device__ __forceinline__ T operator()(int q) const {
    return Load()(p + q * stride);
  }
};

// kBands > 0: the band count is known when compiling (the bsgs kernel), and
// the band loop is unrolled so that a cell's loads of all its bands can be
// in flight together (nbands is then kBands); 0 (banded_apply.cu): `nbands`
// bands in a plain loop.
// Either way each band adds the same products in the same order.
template <typename T, int V, int kBands = 0, typename Band, typename LoadX>
__device__ __forceinline__ void banded_block_apply(
    const Band& band, const T* __restrict__ x, int nc, int c, int nbands,
    const Offsets& off, const T* base, T sign, LoadX ldx, T* y) {
  T acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = T(0);
  auto add_band = [&](int k) {
    if (!band.has(k)) return;
    int r = (c + off.d[k]) % nc;
    if (r < 0) r += nc;
    const T* xr = x + static_cast<int64_t>(r) * V;
    T xv[V];
    ldx.row(xr, xv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[i] += band((k * V + i) * V + j) * xv[j];
      }
    }
  };
  if constexpr (kBands > 0) {
#pragma unroll
    for (int k = 0; k < kBands; ++k) add_band(k);
  } else {
    for (int k = 0; k < nbands; ++k) add_band(k);
  }
  if (base != nullptr) {
#pragma unroll
    for (int i = 0; i < V; ++i) y[i] = base[i] + sign * acc[i];
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) y[i] = sign * acc[i];
  }
}

}  // namespace fvens
