// CUDA-graph conditional (IF) nodes from inside a PyTorch stream capture,
// bound through a plain C interface.
//
// Replaces no Pallas kernel. It is how the port's captured implicit step
// (solver/device_stepping.py) expresses the JAX package's device-side
// control flow, lax.while_loop over the Krylov iterations and lax.cond
// over the blocked path's second pass and the restarts
// (fvens_tpu/solver/linear.py:424, 471, 500, 520): each guarded body is
// captured into the body graph of an IF node whose condition a one-thread
// kernel sets, at every replay, from a bool in device memory. A dead
// iteration then costs that kernel and the node, not its matvec,
// preconditioner and Gram-Schmidt pass. (PyTorch 2.13 has the same
// mechanism as CUDAGraph.begin_capture_to_if_node; the torch this port
// runs on may not, so the port carries its own.)
//
// fvens_if_begin(stream, pred, body_stream):
//   1. reads the graph `stream` is capturing into and its current
//      dependencies (cudaStreamGetCaptureInfo);
//   2. creates a conditional handle in that graph and captures, on
//      `stream`, set_if_kernel, which sets the handle to *pred when the
//      graph runs;
//   3. adds an IF node after it, makes it the stream's only capture
//      dependency, and starts capturing `body_stream` into the node's body
//      graph (cudaStreamBeginCaptureToGraph, relaxed mode).
// The caller then queues the body's work on `body_stream` and calls
// fvens_if_end(body_stream), which ends that capture. Nested bodies use one
// body stream per depth.
//
// What bounds set_if_kernel: nothing but its launch; it reads one byte.

#include <cuda_runtime.h>

namespace {

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

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

int fvens_if_begin(void* stream_ptr, const void* pred, void* body_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStream_t body = static_cast<cudaStream_t>(body_ptr);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(stream, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) {
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = capture_info(stream, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed));
}

int fvens_if_end(void* body_ptr) {
  cudaGraph_t graph = nullptr;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_ptr), &graph));
}

const char* fvens_if_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
