// The node count of a CUDA graph while it is being captured, for the span
// labels of utils/profiling.py: a span that opens and closes inside a
// capture records the count at both ends, and the trace's summary charges
// the ops of every replay to the span by their position in the graph.
//
// Only kernel, memset and memcpy nodes are counted: they are the nodes a
// replay runs as device events (torch.profiler's kernel, gpu_memset and
// gpu_memcpy records).  Event record, event wait and empty nodes leave none.
// Host code only: no kernel here.

#include <cuda_runtime.h>

#include <vector>

extern "C" long long repnerv_capture_nodes(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  // the four-argument form compiles against CUDA 12 and 13 alike (the rest
  // of the arguments default to null)
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, nullptr, &graph) !=
      cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launch check
    return -2;
  }
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return -1;
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess) {
    cudaGetLastError();
    return -2;
  }
  std::vector<cudaGraphNode_t> nodes(n);
  if (n && cudaGraphGetNodes(graph, nodes.data(), &n) != cudaSuccess) {
    cudaGetLastError();
    return -2;
  }
  long long count = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) {
      cudaGetLastError();
      return -2;
    }
    if (type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemset ||
        type == cudaGraphNodeTypeMemcpy) {
      ++count;
    }
  }
  return count;
}
