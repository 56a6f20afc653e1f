// CUDA-graph conditional (IF) nodes from inside a PyTorch stream capture,
// and the compare-and-set kernel that decides them, bound through a plain C
// interface.
//
// Replaces no Pallas kernel. It is how the port's captured implicit step
// (solver/device_stepping.py) expresses the JAX package's device-side
// control flow, lax.while_loop over the Krylov iterations and lax.cond
// over the blocked path's second pass and the restarts
// (fvens_tpu/solver/linear.py:424, 471, 500, 520): each guarded body is
// captured into the body graph of an IF node. A dead iteration then costs
// the node, not its matvec, preconditioner and Gram-Schmidt pass. (PyTorch
// 2.13 has the generic mechanism as CUDAGraph.begin_capture_to_if_node;
// the torch this port runs on may not, so the port carries its own.)
//
// Two ways to decide a node:
//
//   - a condition set where it is computed. fvens_if_handle creates, in the
//     graph a stream is capturing into, a handle whose condition the graph
//     resets to 0 at every launch (cudaGraphCondAssignDefault), and
//     fvens_if_begin_handle adds an IF node on it with nothing in front.
//     Whatever kernel computes the predicate sets the handle: the
//     compare-and-set kernel below, or the Givens update of the previous
//     Krylov iteration (csrc/givens_column.cu), which is how the Krylov
//     iterations chain. A node whose handle nothing set stays dead.
//   - the generic form, for a predicate that a torch op computed into a
//     bool in device memory: fvens_if_begin creates a handle, captures
//     set_if_kernel (one thread: handle = *pred) and adds the IF node.
//
// Both then start capturing `body_stream` into the node's body graph
// (cudaStreamBeginCaptureToGraph, relaxed mode); the caller queues the
// body's work on `body_stream` and calls fvens_if_end(body_stream), which
// ends that capture. Nested bodies use one body stream per depth.
//
// fvens_cond_set(device, op, dtype, a, b, scale, out, handle, set, stream)
// launches one thread that forms p = a < scale * b, a > b or a == 0 from two
// device scalars (f32, f64; int32 for a == 0), writes p to the bool `out`
// where one is given and sets `handle` to p where `set`. The product rounds
// as torch's `scale * b` does at b's dtype: scale rounded to that dtype
// first, then one IEEE product (__fmul_rn / __dmul_rn, no contraction), so
// every decision is the torch ops' bit for bit.
//
// What bounds both kernels: nothing but their launch; each reads a few
// bytes and writes at most one.

#include <cuda_runtime.h>

namespace {

constexpr int kLess = 0;       // a < scale * b
constexpr int kGreater = 1;    // a > b
constexpr int kZero = 2;       // a == 0
constexpr int kMaxDevices = 64;

// the graph a stream is capturing into and its current dependencies (the
// edge data that CUDA 13 adds is not used)
cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         unsigned long long* id, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
#if CUDART_VERSION >= 13000
  const cudaGraphEdgeData* edges = nullptr;
  return cudaStreamGetCaptureInfo(stream, status, id, graph, deps, &edges,
                                  ndeps);
#else
  return cudaStreamGetCaptureInfo(stream, status, id, graph, deps, ndeps);
#endif
}

// the graph `stream` is capturing into, or an error where it captures none
cudaError_t capture_graph(cudaStream_t stream, cudaGraph_t* graph,
                          const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  *graph = nullptr;
  cudaError_t err = capture_info(stream, &status, &id, graph, deps, ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive || *graph == nullptr) {
    return cudaErrorStreamCaptureImplicit;
  }
  return cudaSuccess;
}

// an IF node on `handle` after the stream's current dependencies, made its
// only dependency; `body` starts capturing into the node's body graph
cudaError_t add_if_node(cudaStream_t stream, cudaGraphConditionalHandle handle,
                        cudaStream_t body) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_graph(stream, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
}

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ int mul_rn(int a, int b) { return a * b; }

template <typename T>
__global__ void cond_set_kernel(int op, const T* __restrict__ a,
                                const T* __restrict__ b, T scale,
                                bool* __restrict__ out,
                                cudaGraphConditionalHandle handle, int set) {
  const T x = *a;
  bool p;
  if (op == kLess) {
    p = x < mul_rn(scale, *b);
  } else if (op == kGreater) {
    p = x > *b;
  } else {
    p = x == T(0);
  }
  if (out != nullptr) *out = p;
  if (set) cudaGraphSetConditional(handle, p ? 1u : 0u);
}

template <typename T>
cudaError_t launch_cond_set(int op, const void* a, const void* b,
                            double scale, void* out,
                            cudaGraphConditionalHandle handle, int set,
                            cudaStream_t stream) {
  cond_set_kernel<T><<<1, 1, 0, stream>>>(
      op, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T>(scale), static_cast<bool*>(out), handle, set);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success).

int fvens_if_handle(void* stream_ptr, unsigned long long* handle_out) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_graph(static_cast<cudaStream_t>(stream_ptr),
                                  &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

int fvens_if_begin_handle(void* stream_ptr, unsigned long long handle,
                          void* body_ptr) {
  return static_cast<int>(add_if_node(
      static_cast<cudaStream_t>(stream_ptr),
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<cudaStream_t>(body_ptr)));
}

int fvens_if_begin(void* stream_ptr, const void* pred, void* body_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_graph(stream, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      add_if_node(stream, handle, static_cast<cudaStream_t>(body_ptr)));
}

int fvens_if_end(void* body_ptr) {
  cudaGraph_t graph = nullptr;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_ptr), &graph));
}

// dtype: 0 float32, 1 float64, 2 int32 (op kZero only)
int fvens_cond_set(int device, int op, int dtype, const void* a,
                   const void* b, double scale, void* out,
                   unsigned long long handle, int set, void* stream_ptr) {
  if (device < 0 || device >= kMaxDevices || op < kLess || op > kZero ||
      dtype < 0 || dtype > 2 || (dtype == 2 && op != kZero)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaGraphConditionalHandle h =
      static_cast<cudaGraphConditionalHandle>(handle);
  if (dtype == 0) {
    err = launch_cond_set<float>(op, a, b, scale, out, h, set, stream);
  } else if (dtype == 1) {
    err = launch_cond_set<double>(op, a, b, scale, out, h, set, stream);
  } else {
    err = launch_cond_set<int>(op, a, b, scale, out, h, set, stream);
  }
  return static_cast<int>(err);
}

const char* fvens_if_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
