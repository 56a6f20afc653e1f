// One Givens/Hessenberg column update of FGMRES for Hopper (sm_90a), bound
// through a plain C interface.
//
// Replaces no Pallas kernel: it is the device form of the JAX package's
// Arnoldi bookkeeping, the `rot` fori_loop and the rotation update inside
// the FGMRES while body (fvens_tpu/solver/linear.py:400-420 and 480-495),
// which XLA runs on the TPU as part of the one device program of a step.
// The port's host-controlled gmres does the same arithmetic in NumPy on the
// host (solver/linear.py:_hessenberg_column), fed by one device->host copy
// per Krylov iteration; this kernel lets a whole GMRES cycle stay on the
// card, so that a captured step graph (solver/device_stepping.py) needs no
// host read between its Krylov iterations.
//
// For Krylov iteration j of a cycle of at most m, with h[0..j] the new
// column's projections and hn the norm of the orthogonalized vector, one
// block of kThreads threads does, at the Krylov dtype:
//   1. stage (h, hn), cs[0..j) and sn[0..j) in shared memory;
//   2. thread 0 applies the j stored rotations to the column, forms
//      rotation j (denom = sqrt(a a + b b), c = a / max(denom, tiny),
//      s = b / max(denom, tiny)), updates g (g[j+1] = -s g[j],
//      g[j] = c g[j]), writes res = |g[j+1]|,
//      live <- live && res > tol && j + 1 < m, and iters += 1;
//   3. all threads store the column into H[:, j] (zeros below row j + 1).
// A call with live false changes nothing, so a caller that cannot skip a
// dead iteration (the eager, masked cycle) may still launch it.
//
// Rounding: every product, sum, square root and quotient is a separately
// rounded IEEE operation (__fmul_rn / __fadd_rn / __fsqrt_rn / __fdiv_rn and
// their double forms): no FMA contraction and no approximate square root
// or division, so the kernel rounds as its plain PyTorch twin (solver/
// givens_kernels.py) does, bit for bit, and as NumPy's scalar arithmetic
// does in the host's _hessenberg_column but for the two squares: the kernel
// forms them as products, as the JAX package's x ** 2 (an XLA multiply)
// does, where NumPy's scalar ** 2 calls pow, which rounds about one square
// in 1,500 to the other neighbour. A NaN column propagates (the clamp keeps
// a NaN denominator) and makes live false.
//
// What bounds it: nothing the card is fast at. It moves a few hundred bytes
// and does about 6 j operations in a dependent chain, so a launch is
// latency-bound: the launch itself and one thread's chain of j rotations
// (a few cycles each). The design keeps the chain in shared memory and
// registers; it does not try to parallelise a recurrence that has no
// parallelism.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRestart = 512;           // the wrapper refuses larger m
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
givens_column_kernel(const T* __restrict__ h, const T* __restrict__ hn, int j,
                     int m, T* __restrict__ H, T* __restrict__ cs,
                     T* __restrict__ sn, T* __restrict__ g,
                     T* __restrict__ res, const T* __restrict__ tol,
                     bool* __restrict__ live, int* __restrict__ iters,
                     T tiny) {
  __shared__ T col[kMaxRestart + 1];
  __shared__ T scs[kMaxRestart];
  __shared__ T ssn[kMaxRestart];
  // every thread reads live before the barrier below; thread 0 writes it
  // only after that barrier
  if (!*live) return;
  for (int i = threadIdx.x; i <= j; i += kThreads) col[i] = h[i];
  if (threadIdx.x == 0) col[j + 1] = *hn;
  for (int i = threadIdx.x; i < j; i += kThreads) {
    scs[i] = cs[i];
    ssn[i] = sn[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // rotation i mixes entries i and i + 1; `cur` carries entry i as the
    // rotations before it left it, entry i + 1 is still the input's
    T cur = col[0];
    for (int i = 0; i < j; ++i) {
      const T c = scs[i], s = ssn[i], nxt = col[i + 1];
      col[i] = add_rn(mul_rn(c, cur), mul_rn(s, nxt));
      cur = add_rn(mul_rn(-s, cur), mul_rn(c, nxt));
    }
    const T a = cur, b = col[j + 1];
    const T denom = sqrt_rn(add_rn(mul_rn(a, a), mul_rn(b, b)));
    const T d = (denom < tiny) ? tiny : denom;    // a NaN stays NaN
    const T c = div_rn(a, d);
    const T s = div_rn(b, d);
    col[j] = denom;
    col[j + 1] = T(0);
    cs[j] = c;
    sn[j] = s;
    const T gj = g[j];
    const T g1 = mul_rn(-s, gj);
    g[j + 1] = g1;
    g[j] = mul_rn(c, gj);
    const T r = fabs(g1);                       // clears a -0's sign
    *res = r;
    *live = (r > *tol) && (j + 1 < m);
    *iters += 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= m; i += kThreads) {
    H[static_cast<int64_t>(i) * m + j] = i <= j + 1 ? col[i] : T(0);
  }
}

template <typename T>
int launch(int device, const void* h, const void* hn, int j, int m, void* H,
           void* cs, void* sn, void* g, void* res, const void* tol,
           void* live, void* iters, double tiny, void* stream) {
  if (device < 0 || device >= kMaxDevices || m < 1 || m > kMaxRestart ||
      j < 0 || j >= m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  givens_column_kernel<T><<<1, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<const T*>(hn), j, m,
      static_cast<T*>(H), static_cast<T*>(cs), static_cast<T*>(sn),
      static_cast<T*>(g), static_cast<T*>(res), static_cast<const T*>(tol),
      static_cast<bool*>(live), static_cast<int*>(iters),
      static_cast<T>(tiny));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success); a launch that
// the runtime refuses never runs, so the caller must check it.
int fvens_givens_column_f32(int device, const void* h, const void* hn, int j,
                            int m, void* H, void* cs, void* sn, void* g,
                            void* res, const void* tol, void* live,
                            void* iters, double tiny, void* stream) {
  return launch<float>(device, h, hn, j, m, H, cs, sn, g, res, tol, live,
                       iters, tiny, stream);
}

int fvens_givens_column_f64(int device, const void* h, const void* hn, int j,
                            int m, void* H, void* cs, void* sn, void* g,
                            void* res, const void* tol, void* live,
                            void* iters, double tiny, void* stream) {
  return launch<double>(device, h, hn, j, m, H, cs, sn, g, res, tol, live,
                        iters, tiny, stream);
}

const char* fvens_givens_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
