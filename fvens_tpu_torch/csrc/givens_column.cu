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
// warp does, at the Krylov dtype:
//   1. applies the j stored rotations to the column in chunks of 32: lane l
//      loads rotation (base + l)'s c and s and entry base + l + 1 of the
//      column, the next chunk's loads issued before this chunk's rotations
//      run; every lane then runs the chunk's rotations on the same values,
//      each operand broadcast from its lane's registers (__shfl_sync), the
//      chunk unrolled without a branch (past rotation j - 1 the lanes hold
//      exact identity rotations), so that the shuffles run ahead of the
//      dependent chain and a rotation costs its two dependent operations
//      (a product and a sum) and no load; lane l keeps the entry that
//      rotation base + l finishes and stores it into H;
//   2. forms rotation j (denom = sqrt(a a + b b), c = a / max(denom, tiny),
//      s = b / max(denom, tiny)), updates g (g[j+1] = -s g[j],
//      g[j] = c g[j]), writes res = |g[j+1]|,
//      live <- live && res > tol && j + 1 < m, iters += 1 (lane 0);
//   3. stores the rest of column j of H (denom, then zeros below row j);
//   4. inside a captured graph (solver/linear.py:gmres_device through
//      solver/graph_if.py), lane 0 sets the condition of the next Krylov
//      iteration's IF node (or of the next group's node) to the new live:
//      that is what decides the next node, so the chain of iterations needs
//      no set-condition kernel, and a dead iteration, which never runs,
//      leaves every later node of its cycle at its default, dead.
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
// latency-bound: the launch itself, the loads of a chunk (one round trip
// each, the next overlapped with the current) and a chain of j rotations of
// two dependent operations each. The recurrence has no parallelism to use;
// the design keeps loads and shuffles off it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRestart = 512;           // the wrapper refuses larger m
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

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
__global__ void __launch_bounds__(kWarp)
givens_column_kernel(const T* __restrict__ h, const T* __restrict__ hn, int j,
                     int m, T* __restrict__ H, T* __restrict__ cs,
                     T* __restrict__ sn, T* __restrict__ g,
                     T* __restrict__ res, const T* __restrict__ tol,
                     bool* __restrict__ live, int* __restrict__ iters,
                     T tiny, cudaGraphConditionalHandle next, int set_next) {
  // every lane reads live here; lane 0 writes it only at the end
  if (!*live) return;
  const int lane = threadIdx.x;
  const T b = *hn;
  const T gj = g[j];
  // rotation i mixes entries i and i + 1; `cur` carries entry i as the
  // rotations before it left it, entry i + 1 is still the input's
  T cur = h[0];
  // past rotation j - 1 a lane holds the identity rotation: c 0, s -1 and
  // entry -0 give cur' = 1 cur + 0 (-0) = cur bit for bit (-0 and NaN
  // included), so a chunk runs all its 32 rotations without a branch
  T c_next = T(0), s_next = T(-1), x_next = -T(0);
  if (lane < j) {
    c_next = cs[lane];
    s_next = sn[lane];
    x_next = h[lane + 1];
  }
  for (int base = 0; base < j; base += kWarp) {
    const T c_l = c_next, s_l = s_next, x_l = x_next;
    const int i_next = base + kWarp + lane;
    c_next = T(0);
    s_next = T(-1);
    x_next = -T(0);
    if (i_next < j) {                     // the next chunk, in flight
      c_next = cs[i_next];
      s_next = sn[i_next];
      x_next = h[i_next + 1];
    }
    T mine = T(0);
#pragma unroll
    for (int k = 0; k < kWarp; ++k) {
      const T c = __shfl_sync(kFull, c_l, k);
      const T s = __shfl_sync(kFull, s_l, k);
      const T nxt = __shfl_sync(kFull, x_l, k);
      const T out = add_rn(mul_rn(c, cur), mul_rn(s, nxt));
      cur = add_rn(mul_rn(-s, cur), mul_rn(c, nxt));
      if (lane == k) mine = out;
    }
    if (base + lane < j) H[static_cast<int64_t>(base + lane) * m + j] = mine;
  }
  const T a = cur;
  const T denom = sqrt_rn(add_rn(mul_rn(a, a), mul_rn(b, b)));
  for (int i = j + lane; i <= m; i += kWarp) {
    H[static_cast<int64_t>(i) * m + j] = i == j ? denom : T(0);
  }
  if (lane == 0) {
    const T d = (denom < tiny) ? tiny : denom;    // a NaN stays NaN
    const T c = div_rn(a, d);
    const T s = div_rn(b, d);
    cs[j] = c;
    sn[j] = s;
    const T g1 = mul_rn(-s, gj);
    g[j + 1] = g1;
    g[j] = mul_rn(c, gj);
    const T r = fabs(g1);                       // clears a -0's sign
    *res = r;
    const bool alive = (r > *tol) && (j + 1 < m);
    *live = alive;
    *iters += 1;
    if (set_next) cudaGraphSetConditional(next, alive ? 1u : 0u);
  }
}

template <typename T>
int launch(int device, const void* h, const void* hn, int j, int m, void* H,
           void* cs, void* sn, void* g, void* res, const void* tol,
           void* live, void* iters, double tiny, unsigned long long next,
           int set_next, void* stream) {
  if (device < 0 || device >= kMaxDevices || m < 1 || m > kMaxRestart ||
      j < 0 || j >= m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  givens_column_kernel<T><<<1, kWarp, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<const T*>(hn), j, m,
      static_cast<T*>(H), static_cast<T*>(cs), static_cast<T*>(sn),
      static_cast<T*>(g), static_cast<T*>(res), static_cast<const T*>(tol),
      static_cast<bool*>(live), static_cast<int*>(iters),
      static_cast<T>(tiny), static_cast<cudaGraphConditionalHandle>(next),
      set_next);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success); a launch that
// the runtime refuses never runs, so the caller must check it.
int fvens_givens_column_f32(int device, const void* h, const void* hn, int j,
                            int m, void* H, void* cs, void* sn, void* g,
                            void* res, const void* tol, void* live,
                            void* iters, double tiny, unsigned long long next,
                            int set_next, void* stream) {
  return launch<float>(device, h, hn, j, m, H, cs, sn, g, res, tol, live,
                       iters, tiny, next, set_next, stream);
}

int fvens_givens_column_f64(int device, const void* h, const void* hn, int j,
                            int m, void* H, void* cs, void* sn, void* g,
                            void* res, const void* tol, void* live,
                            void* iters, double tiny, unsigned long long next,
                            int set_next, void* stream) {
  return launch<double>(device, h, hn, j, m, H, cs, sn, g, res, tol, live,
                        iters, tiny, next, set_next, stream);
}

const char* fvens_givens_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
