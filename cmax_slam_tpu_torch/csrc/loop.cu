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
// node per lane of a stride, each keyed on a gate that the segments before
// it wrote on the device. The host launches that graph once per solve and
// reads nothing until it ends.
//
// A gate is a bool (or uint8) mask of L lanes (1 for a packet solve, up to
// the lanes of a batched round) and, optionally, an int32 counter and limit:
// it holds while any lane of the mask is set and the counter is below the
// limit. The predicate kernel (loop_pred) reduces the mask itself (one warp
// for L <= 32, else one block joined by __syncthreads_or), reads the
// counter, sets the conditional node's handle (cudaGraphSetConditional) and,
// when the body is to run, adds one to that node's float execution counter,
// from which the host later counts the kernel launches the body made. So a
// gate costs no kernel of its own beyond the mask's: the segments write the
// lanes' mask into the gate's static buffer and launch no reduction or
// cast. It reads at most L + 8 bytes and writes 4: its bound is the launch
// (about a microsecond). Its node's latency in the graph, not its body, is
// what a loop iteration pays for it.
//
// Loop clocks (a program built while the trace is armed): a WHILE node's
// predicates also get a pointer to an int64 pair {start, total} of that
// node. The predicate before the node stores %globaltimer (ns) in start
// when the loop is to run; the predicate that ends the loop (at the end of
// its body) adds now - start to total. An inner loop's entry predicate runs
// in its outer loop's body, so nested loops are timed each on its own. With
// a null pointer (unarmed) nothing else is read or written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The gate's lanes and its optional counter/limit pair (both null or both
// set), as loop_add_cond and loop_add_pred take them.
struct Gate {
  const unsigned char* mask;
  int lanes;
  const int* counter;
  const int* limit;
};

// Where a predicate stands for its loop clock: before a WHILE node, at the
// end of its body, or neither (an IF node).
enum ClockRole : int { kNoClock = 0, kLoopEntry = 1, kLoopEnd = 2 };

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void loop_pred(cudaGraphConditionalHandle handle, Gate g, float* count,
                          long long* clock, int role) {
  const bool below = g.counter == nullptr || threadIdx.x != 0 || *g.counter < *g.limit;
  bool any = false;
  for (int i = threadIdx.x; i < g.lanes; i += blockDim.x) any |= g.mask[i] != 0;
  any = blockDim.x == 32 ? __any_sync(0xffffffffu, any) : __syncthreads_or(any);
  if (threadIdx.x == 0) {
    const unsigned int go = any && below;
    if (go) *count += 1.0f;
    if (clock != nullptr) {
      if (role == kLoopEntry && go) {
        clock[0] = global_ns();
      } else if (role == kLoopEnd && !go) {
        clock[1] += global_ns() - clock[0];
      }
    }
    cudaGraphSetConditional(handle, go);
  }
}

constexpr int kMaxPredThreads = 1024;

cudaError_t add_pred(cudaGraph_t graph, cudaGraphNode_t dep, cudaGraphConditionalHandle handle,
                     Gate gate, float* count, long long* clock, int role,
                     cudaGraphNode_t* out) {
  if (gate.mask == nullptr || gate.lanes < 1 ||
      (gate.counter == nullptr) != (gate.limit == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (clock == nullptr) role = kNoClock;
  void* args[] = {&handle, &gate, &count, &clock, &role};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_pred);
  p.gridDim = dim3(1);
  const int threads = (gate.lanes + 31) / 32 * 32;  // one warp up to 32 lanes
  p.blockDim = dim3(threads < kMaxPredThreads ? threads : kMaxPredThreads);
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

// After `dep`: a predicate node reading the gate (mask of `lanes` bytes;
// counter and limit both null or both set), then a conditional node
// (is_while 0: IF, 1: WHILE) on its handle. Returns the conditional node, its
// body graph and the handle. A WHILE body must end with loop_add_pred on the
// same handle, gate and clock, which decides the next iteration. `clock` is
// the WHILE node's int64 {start, total} pair, or null (no loop clock; an IF
// node's is ignored).
int loop_add_cond(cudaGraph_t graph, cudaGraphNode_t dep, int is_while,
                  const unsigned char* mask, int lanes, const int* counter, const int* limit,
                  float* count, long long* clock, cudaGraphNode_t* out, cudaGraph_t* body,
                  cudaGraphConditionalHandle* handle) {
  cudaError_t e = cudaGraphConditionalHandleCreate(handle, graph, 0, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t pred;
  e = add_pred(graph, dep, *handle, Gate{mask, lanes, counter, limit}, count,
               is_while ? clock : nullptr, kLoopEntry, &pred);
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
                  const unsigned char* mask, int lanes, const int* counter, const int* limit,
                  float* count, long long* clock, cudaGraphNode_t* out) {
  return add_pred(graph, dep, handle, Gate{mask, lanes, counter, limit}, count, clock,
                  kLoopEnd, out);
}

int loop_instantiate(cudaGraph_t graph, cudaGraphExec_t* exec) {
  return cudaGraphInstantiate(exec, graph, 0);
}

int loop_launch(cudaGraphExec_t exec, void* stream) {
  return cudaGraphLaunch(exec, static_cast<cudaStream_t>(stream));
}

int loop_exec_destroy(cudaGraphExec_t exec) { return cudaGraphExecDestroy(exec); }

// The nodes of a graph (not of its child graphs) and how many of them are
// kernel nodes (chip_smoke's split of a captured objective evaluation).
int loop_graph_nodes(cudaGraph_t graph, size_t* total, size_t* kernels) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  *total = n;
  *kernels = 0;
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err == cudaSuccess && type == cudaGraphNodeTypeKernel) ++*kernels;
  }
  delete[] nodes;
  return (int)err;
}

const char* loop_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
