// While loops of CUDA graphs for Hopper (sm_90a), plain C interface: the
// port's counterpart of lax.while_loop, for MAC's LOBPCG stages and for the
// distributed PGO solve.
//
// Replaces no TPU kernel. The JAX package runs each LOBPCG stage of its
// Woodbury tier as a lax.while_loop inside the one compiled Frank-Wolfe
// program (cslam_tpu/ops/fiedler.py, JAX's lobpcg_standard), and the whole
// distributed solve as one jitted program whose sweep loop, each robot's LM
// loop and each LM step's CG loop are nested while loops
// (cslam_tpu/pgo/distributed.py:644-761), every stop test decided on the
// device. The port captures each loop body's programs as CUDA graphs
// (utils/tier_graphs.StepGraphs); a host loop around them would read a stop
// flag after every iteration. Here the captured programs become a plan:
// a sequence of child graph nodes and conditional WHILE nodes (CUDA 12.4+),
// each WHILE node a body of the same kind, nested to any depth:
//
//   set(flag) -> WHILE(handle) { body, in order -> set(flag) }
//
// where set is a one-thread kernel that writes the device flag (a 0-d bool
// of the loop state, cleared by the body once the loop stops) into the
// conditional handle. One launch runs the whole plan: no host read, and no
// iteration past a stop. The captured graphs are embedded as child graph
// nodes (CUDA copies them; the tensors they address stay owned by the
// captures, which the caller keeps alive). A child graph may not hold a
// conditional node, so a nested WHILE node is added to its parent's body
// graph itself, with a handle of that body graph.
//
// What bounds it: the bodies' own device time; each loop adds one
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

// the plan's item kinds (cslam_plan_create)
constexpr int kGraph = 0;
constexpr int kWhile = 1;
constexpr int kEnd = 2;

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

// Append items kinds/ptrs[*pos ..] to graph g after *prev (null: no
// dependency), up to the matching kEnd or the plan's end; *prev becomes
// the last node added.
int build(cudaGraph_t g, const int* kinds, void* const* ptrs, int n, int* pos,
          cudaGraphNode_t* prev) {
  while (*pos < n) {
    const int kind = kinds[*pos];
    void* ptr = ptrs[*pos];
    ++*pos;
    const cudaGraphNode_t* dep = *prev ? prev : nullptr;
    if (kind == kEnd) return 0;
    if (kind == kGraph) {
      cudaGraphNode_t child;
      int rc = static_cast<int>(cudaGraphAddChildGraphNode(
          &child, g, dep, dep ? 1 : 0, static_cast<cudaGraph_t>(ptr)));
      if (rc != 0) return rc;
      *prev = child;
      continue;
    }
    if (kind != kWhile || ptr == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const void* flag = ptr;
    cudaGraphConditionalHandle handle;
    int rc = static_cast<int>(cudaGraphConditionalHandleCreate(
        &handle, g, 0, cudaGraphCondAssignDefault));
    if (rc != 0) return rc;
    cudaGraphNode_t set0;
    rc = add_set_node(g, dep, &handle, &flag, &set0);
    if (rc != 0) return rc;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    cudaGraphNode_t loop_node;
    rc = static_cast<int>(cudaGraphAddNode(&loop_node, g, &set0, 1, &cp));
    if (rc != 0) return rc;
    cudaGraph_t body = cp.conditional.phGraph_out[0];
    cudaGraphNode_t last = nullptr;
    rc = build(body, kinds, ptrs, n, pos, &last);
    if (rc != 0) return rc;
    cudaGraphNode_t set1;
    rc = add_set_node(body, last ? &last : nullptr, &handle, &flag, &set1);
    if (rc != 0) return rc;
    *prev = loop_node;
  }
  return 0;
}

}  // namespace

extern "C" {

// Build an executable graph from a plan of n items: kinds[i] is 0 for a
// captured graph (ptrs[i] a cudaGraph_t, embedded as a child graph node),
// 1 for the start of a WHILE loop (ptrs[i] its device flag, one byte,
// nonzero = iterate), whose body is the items up to the matching 2 (end).
// Items run in order. *out receives an opaque plan for cslam_while_launch,
// kept for the life of the process (as the captures it embeds). Returns a
// cudaError_t (0 on success).
int cslam_plan_create(const int* kinds, void* const* ptrs, int n,
                      void** out) {
  if (n < 1 || kinds == nullptr || ptrs == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Loop* loop = new Loop();
  int rc = static_cast<int>(cudaGraphCreate(&loop->graph, 0));
  if (rc != 0) {
    delete loop;
    return rc;
  }
  int pos = 0;
  cudaGraphNode_t last = nullptr;
  rc = build(loop->graph, kinds, ptrs, n, &pos, &last);
  if (rc == 0 && pos != n) rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc == 0)
    rc = static_cast<int>(cudaGraphInstantiate(&loop->exec, loop->graph, 0));
  if (rc != 0) {
    cudaGraphDestroy(loop->graph);
    delete loop;
    return rc;
  }
  *out = loop;
  return 0;
}

// Launch a plan built by cslam_plan_create on a stream.
int cslam_while_launch(void* loop, void* stream) {
  if (loop == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphLaunch(static_cast<Loop*>(loop)->exec,
                                          static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
