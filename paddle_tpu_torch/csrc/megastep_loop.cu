// The megastep's trip loop as one CUDA graph with a conditional WHILE node
// (Hopper, sm_90a; conditional WHILE nodes need CUDA 12.4 or later in the
// driver and the runtime).
//
// Replaces no Pallas kernel: it is the counterpart of the reference's
// lax.while_loop in paddle_tpu/serving/paged_kv.py: _megastep_impl (the loop
// at line 524, its cond at lines 472-474, cond = (t < k_eff) & any(live)).
// The port captures one decode trip into a CUDA graph (PyTorch's
// torch.cuda.CUDAGraph). This file builds the graph that runs it:
//
//   [condition kernel] -> WHILE(handle) { [captured trip] -> [condition kernel] }
//
// The condition kernel reads the megastep's int64 state vector and sets the
// WHILE node's handle to (t < k_eff && any(live[0:S])): the first one before
// the loop (so a chained megastep whose slots all froze runs no trip, as the
// reference's loop runs none), then one at the end of every body iteration,
// which also adds one to the state's iteration counter. The captured trip
// enters the body as a child-graph node (a copy of PyTorch's graph: the same
// kernels over the same addresses, so the pools, the page table and the
// state vector the trip captured are the ones it reads).
//
// Bound: the condition kernel reads S + 2 int64 and writes one (one block,
// a few hundred bytes: launch latency bounds it); the loop's cost is its
// trips, which stop on the device as soon as no slot is live.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Offsets {
  int S, live, t, k_eff, iters;
};

__global__ void megastep_cond_kernel(cudaGraphConditionalHandle handle,
                                     long long* state, Offsets o,
                                     int count) {
  int any = 0;
  for (int i = threadIdx.x; i < o.S; i += blockDim.x)
    any |= state[o.live + i] != 0;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    if (count) state[o.iters] += 1;
    cudaGraphSetConditional(handle,
                            (state[o.t] < state[o.k_eff] && any) ? 1u : 0u);
  }
}

cudaError_t add_cond(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t ndeps,
                     cudaGraphConditionalHandle* handle, long long** state,
                     Offsets* o, int* count) {
  void* args[] = {handle, state, o, count};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(megastep_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(kThreads);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &p);
}

struct Loop {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

}  // namespace

// Build and instantiate the loop graph around `trip` (a cudaGraph_t, which
// is copied: the caller keeps ownership of it). `state` is the device
// address of the int64 state vector; the offsets are in elements. On
// success *out holds the loop (free it with paddle_megastep_loop_free).
extern "C" int paddle_megastep_loop_build(void* trip, void* state, int S,
                                          int live, int t, int k_eff,
                                          int iters, void** out) {
  Loop* loop = new Loop();
  cudaError_t err = cudaGraphCreate(&loop->graph, 0);
  cudaGraphConditionalHandle handle = 0;
  long long* st = static_cast<long long*>(state);
  Offsets o = {S, live, t, k_eff, iters};
  int pre = 0, body = 1;
  cudaGraphNode_t first = nullptr, cond = nullptr, child = nullptr,
                  last = nullptr;
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&handle, loop->graph, 0,
                                           cudaGraphCondAssignDefault);
  if (err == cudaSuccess)
    err = add_cond(&first, loop->graph, nullptr, 0, &handle, &st, &o, &pre);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  if (err == cudaSuccess)
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&cond, loop->graph, &first, nullptr, 1, &cp);
#else
    err = cudaGraphAddNode(&cond, loop->graph, &first, 1, &cp);
#endif
  if (err == cudaSuccess) {
    cudaGraph_t inner = cp.conditional.phGraph_out[0];
    err = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0,
                                     static_cast<cudaGraph_t>(trip));
    if (err == cudaSuccess)
      err = add_cond(&last, inner, &child, 1, &handle, &st, &o, &body);
  }
  if (err == cudaSuccess)
    err = cudaGraphInstantiate(&loop->exec, loop->graph, 0);
  if (err != cudaSuccess) {
    if (loop->exec) cudaGraphExecDestroy(loop->exec);
    if (loop->graph) cudaGraphDestroy(loop->graph);
    delete loop;
    *out = nullptr;
    return static_cast<int>(err);
  }
  *out = loop;
  return 0;
}

// One launch of the loop on `stream` (the stream the trip was captured on).
extern "C" int paddle_megastep_loop_launch(void* loop, void* stream) {
  cudaError_t err = cudaGraphLaunch(static_cast<Loop*>(loop)->exec,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" void paddle_megastep_loop_free(void* loop) {
  Loop* l = static_cast<Loop*>(loop);
  if (l == nullptr) return;
  if (l->exec) cudaGraphExecDestroy(l->exec);
  if (l->graph) cudaGraphDestroy(l->graph);
  delete l;
}

extern "C" const char* paddle_megastep_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
