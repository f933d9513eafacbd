// Loop predicate and graph assembly for ops/device_loop.py: the device-side
// control flow of the port's CG solves. Plain C interface, loaded with
// ctypes. Stands for the JAX package's lax.while_loop / lax.cond
// (cmax_slam_tpu/ops/optim.py, cmax_slam_tpu/frontend.py:288); it has no
// Pallas counterpart.
//
// A solve is assembled from segments: CUDA graphs captured by PyTorch
// (torch.cuda.CUDAGraph(keep_graph=True)), each of straight-line tensor
// code that writes its results into static buffers. This file joins them
// into one graph with CUDA 12.4+ conditional nodes: a WHILE node per CG
// loop, per line search's bracket steps and per its secant steps, and an IF
// node per lane of a stride, each keyed on an int32 flag that the segment
// before it wrote on the device. The host launches that graph once per
// solve and reads nothing until it ends.
//
// The predicate kernel (loop_pred) is one thread that reads the flag, sets
// the conditional node's handle (cudaGraphSetConditional) and, when the
// body is to run, adds one to that node's float execution counter, from
// which the host later counts the kernel launches the body made. It reads
// 4 bytes and writes 4: its bound is the launch (about a microsecond).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void loop_pred(cudaGraphConditionalHandle handle, const int* flag, float* count) {
  const unsigned int go = *flag != 0;
  if (go) *count += 1.0f;
  cudaGraphSetConditional(handle, go);
}

cudaError_t add_pred(cudaGraph_t graph, cudaGraphNode_t dep, cudaGraphConditionalHandle handle,
                     const int* flag, float* count, cudaGraphNode_t* out) {
  void* args[] = {&handle, &flag, &count};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_pred);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(out, graph, dep ? &dep : nullptr, dep ? 1 : 0, &p);
}

}  // namespace

extern "C" {

int loop_versions(int* driver, int* runtime) {
  cudaError_t e = cudaDriverGetVersion(driver);
  return e != cudaSuccess ? e : cudaRuntimeGetVersion(runtime);
}

int loop_graph_create(cudaGraph_t* graph) { return cudaGraphCreate(graph, 0); }

int loop_graph_destroy(cudaGraph_t graph) { return cudaGraphDestroy(graph); }

// A node holding a clone of `child`, after `dep` (null: a root node).
int loop_add_child(cudaGraph_t graph, cudaGraphNode_t dep, cudaGraph_t child,
                   cudaGraphNode_t* out) {
  return cudaGraphAddChildGraphNode(out, graph, dep ? &dep : nullptr, dep ? 1 : 0, child);
}

// After `dep`: a predicate node reading `flag`, then a conditional node
// (is_while 0: IF, 1: WHILE) on its handle. Returns the conditional node, its
// body graph and the handle. A WHILE body must end with loop_add_pred on the
// same handle and flag, which decides the next iteration.
int loop_add_cond(cudaGraph_t graph, cudaGraphNode_t dep, int is_while, const int* flag,
                  float* count, cudaGraphNode_t* out, cudaGraph_t* body,
                  cudaGraphConditionalHandle* handle) {
  cudaError_t e = cudaGraphConditionalHandleCreate(handle, graph, 0, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t pred;
  e = add_pred(graph, dep, *handle, flag, count, &pred);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = *handle;
  p.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  e = cudaGraphAddNode(out, graph, &pred, 1, &p);
  if (e != cudaSuccess) return e;
  *body = p.conditional.phGraph_out[0];
  return cudaSuccess;
}

int loop_add_pred(cudaGraph_t graph, cudaGraphNode_t dep, cudaGraphConditionalHandle handle,
                  const int* flag, float* count, cudaGraphNode_t* out) {
  return add_pred(graph, dep, handle, flag, count, out);
}

int loop_instantiate(cudaGraph_t graph, cudaGraphExec_t* exec) {
  return cudaGraphInstantiate(exec, graph, 0);
}

int loop_launch(cudaGraphExec_t exec, void* stream) {
  return cudaGraphLaunch(exec, static_cast<cudaStream_t>(stream));
}

int loop_exec_destroy(cudaGraphExec_t exec) { return cudaGraphExecDestroy(exec); }

const char* loop_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
