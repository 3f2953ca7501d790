// While loops of CUDA graphs for Hopper (sm_90a), plain C interface: the
// port's counterpart of lax.while_loop for MAC's LOBPCG stages.
//
// Replaces no TPU kernel. The JAX package runs each LOBPCG stage of its
// Woodbury tier as a lax.while_loop inside the one compiled Frank-Wolfe
// program (cslam_tpu/ops/fiedler.py, JAX's lobpcg_standard), its stop test
// (all Ritz pairs converged, or the budget spent) decided on the device.
// The port captures one LOBPCG iteration as a CUDA graph
// (utils/tier_graphs.StepGraphs); a host loop around it would read the
// stop flag after every iteration. Here the captured iteration becomes the
// body of a conditional WHILE node (CUDA 12.4+):
//
//   set(flag) -> WHILE(handle) { body graphs, in order -> set(flag) }
//
// where set is a one-thread kernel that writes the device flag (a 0-d bool
// of the loop state, cleared by the body once the loop stops) into the
// conditional handle. One launch runs the whole stage: no host read, and
// no iteration past the stop. The body graphs are embedded as child graph
// nodes (CUDA copies them; the tensors they address stay owned by the
// captures, which the caller keeps alive).
//
// What bounds it: the body's own device time; the loop adds one
// one-thread kernel and one conditional evaluation per iteration, about a
// microsecond or two each on an H100. For MAC's stages the body's least
// time is its bytes: each iteration applies B^-1 twice, and each apply
// (ops/fiedler.woodbury_apply) reads Tinv once and Z twice, so a stage of
// i iterations moves 2 i (P^2 + 2 P (M + 1)) float32, 1.68 ms at 3.35
// TB/s for 6 iterations at P = 8192, M + 1 = 3,073. Its body takes
// several times that, in about 230 small kernels per iteration.
#include <cuda_runtime.h>

namespace {

__global__ void set_from_flag(cudaGraphConditionalHandle handle,
                              const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

struct Loop {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

int add_set_node(cudaGraph_t g, const cudaGraphNode_t* dep,
                 cudaGraphConditionalHandle* handle, const void** flag,
                 cudaGraphNode_t* node) {
  void* args[] = {handle, flag};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_from_flag);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return static_cast<int>(
      cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &kp));
}

}  // namespace

extern "C" {

// Build the loop graph for the body graphs bodies[0 .. n-1] (cudaGraph_t
// each, run in order per iteration) and the device flag (one byte, nonzero
// = iterate). *out receives an opaque loop for cslam_while_launch, kept
// for the life of the process (as the captures it embeds). Returns a
// cudaError_t (0 on success).
int cslam_while_create(void* const* bodies, int n, const void* flag,
                       void** out) {
  if (n < 1 || bodies == nullptr || flag == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Loop* loop = new Loop();
  cudaGraph_t g = nullptr;
  int rc = static_cast<int>(cudaGraphCreate(&g, 0));
  if (rc != 0) {
    delete loop;
    return rc;
  }
  loop->graph = g;
  auto fail = [&](int code) {
    cudaGraphDestroy(g);
    delete loop;
    return code;
  };
  cudaGraphConditionalHandle handle;
  rc = static_cast<int>(cudaGraphConditionalHandleCreate(
      &handle, g, 0, cudaGraphCondAssignDefault));
  if (rc != 0) return fail(rc);
  cudaGraphNode_t set0;
  rc = add_set_node(g, nullptr, &handle, &flag, &set0);
  if (rc != 0) return fail(rc);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop_node;
  rc = static_cast<int>(cudaGraphAddNode(&loop_node, g, &set0, 1, &cp));
  if (rc != 0) return fail(rc);
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < n; ++i) {
    cudaGraphNode_t child;
    rc = static_cast<int>(cudaGraphAddChildGraphNode(
        &child, body, prev ? &prev : nullptr, prev ? 1 : 0,
        static_cast<cudaGraph_t>(bodies[i])));
    if (rc != 0) return fail(rc);
    prev = child;
  }
  cudaGraphNode_t set1;
  rc = add_set_node(body, &prev, &handle, &flag, &set1);
  if (rc != 0) return fail(rc);
  rc = static_cast<int>(cudaGraphInstantiate(&loop->exec, g, 0));
  if (rc != 0) return fail(rc);
  *out = loop;
  return 0;
}

// Launch a loop built by cslam_while_create on a stream.
int cslam_while_launch(void* loop, void* stream) {
  if (loop == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphLaunch(static_cast<Loop*>(loop)->exec,
                                          static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
