// Device-resident loop control on Hopper (sm_90a): for the solver's goal step, a CUDA graph
// whose conditional WHILE nodes run a phase's rounds to convergence and a goal's phases
// round after round of passes, so that a goal is one graph launch and the host never waits
// mid-goal; for the trace rollout, a counted WHILE loop over its time steps (below).
//
// Replaces no Pallas kernel.  It is the counterpart of the JAX package's loop control:
// each phase a lax.while_loop (cruise_control_tpu/analyzer/optimizer.py:436-453) and each
// goal's pass cycle a second while_loop around its phases (:559-587), compiled into one
// dispatch a goal.  In eager PyTorch both loops ran on the host, one wait a round.
//
// The round itself is not written here: the caller captures one round of a phase with
// PyTorch (a cudaGraph_t, ops and the segment-sum kernels as they run eagerly), and this
// file nests those graphs as child graphs inside WHILE nodes, with one-thread control
// kernels that evaluate the loop conditions from int32 scalars in device memory (`ctl`) and
// set the WHILE nodes' conditions:
//
//   goal graph:  GOAL_INIT -> WHILE(pass) {
//                  PASS_INIT -> for each phase k:
//                    PHASE_INIT(k) -> WHILE(k) { round k (child graph) -> PHASE_COND(k) }
//                    -> PHASE_END(k)
//                  -> PASS_END }
//
// ctl layout (int32): it, total, streak, windows (the phase's carry, which the captured
// round reads and updates), rounds, moves, pass moves, passes (the goal's), the control
// kernels the launch ran (each one adds itself), then each phase's rounds summed over the
// passes (its trip count).  The control kernels mirror
// analyzer/optimizer.py's phase_cond and the pass cycle's condition:
//   a phase runs while (streak < windows) && (it < max_rounds);
//   the pass cycle while (pass moves > 0) && (passes < max_passes).
//
// A stack of clusters (the lane form: the JAX package vmaps the goal step, whose batched
// while loops run while ANY lane's condition holds and keep a finished lane's carry) runs
// the same graph with `lanes` > 0 and a second int32 buffer `lane` of kLaneWords rows of
// `lanes` words: each lane's phase carry (it, total, streak, windows), whether it runs the
// next round (active), its rounds, moves, pass moves and passes, and whether its pass
// cycle goes on (pass live).  The captured round reads a lane's carry and `active` and
// writes the carry back (a lane that is not active keeps it); the control kernels compute
// each lane's condition as above and set the WHILE node's condition to "any lane": a phase
// runs while any active lane has streak < windows && it < max_rounds, the pass cycle while
// any lane's pass moved something and its passes < max_passes.  The scalar words then count
// the graph's own trips: it is the rounds the body ran in this phase (the longest lane's),
// so the trip counts and the launch's control kernels keep their meaning.
// Bound: none worth a roofline -- one thread, a few words of device memory a lane, about 2 us
// a round of launch latency inside the graph; what the graph removes is the host's wait.
// Conditional nodes need CUDA 12.3 or later in the runtime and in the driver:
// cc_loop_versions reports both, and the Python side raises below that.
//
// The counted loop (cc_count_loop_build) is the counterpart of a lax.scan over time, the
// trace rollout's (cruise_control_tpu/traces/rollout.py:151): one captured step, which reads
// its step index from ctl, run a fixed number of times in one WHILE node.  Its control
// kernel, count_ctl, zeroes the index before the loop and adds one after each step:
//
//   counted graph:  COUNT_INIT -> WHILE { step (child graph) -> COUNT_NEXT }
//
// ctl layout (int32): the step index, then the control kernels the launch ran.

#include <cuda_runtime.h>

namespace {

enum Slot { kIt = 0, kTotal, kStreak, kWindows, kRounds, kMoves, kPassMoves, kPasses, kCtlRuns, kTrips };
enum LaneSlot { lIt = 0, lTotal, lStreak, lWindows, lActive, lRounds, lMoves, lPassMoves, lPasses, lPassLive,
                kLaneWords };
enum Op { kGoalInit = 0, kPassInit, kPhaseInit, kPhaseCond, kPhaseEnd, kPassEnd };

constexpr int kMaxPhases = 16;

__global__ void loop_ctl(int op, int* ctl, cudaGraphConditionalHandle handle, int phase,
                         int limit, int nphases, int lanes, int* lane) {
  // word w of lane l of a stack
#define LW(w, l) lane[(w) * lanes + (l)]
  unsigned any = 0;
  switch (op) {
    case kGoalInit:
      ctl[kRounds] = 0;
      ctl[kMoves] = 0;
      ctl[kPassMoves] = 0;
      ctl[kPasses] = 0;
      ctl[kCtlRuns] = 0;
      for (int k = 0; k < nphases; ++k) ctl[kTrips + k] = 0;
      for (int l = 0; l < lanes; ++l) {
        LW(lRounds, l) = LW(lMoves, l) = LW(lPassMoves, l) = LW(lPasses, l) = 0;
        LW(lPassLive, l) = 1;
      }
      break;
    case kPassInit:
      ctl[kPassMoves] = 0;
      for (int l = 0; l < lanes; ++l) LW(lPassMoves, l) = 0;
      break;
    case kPhaseInit:
      ctl[kIt] = 0;
      ctl[kTotal] = 0;
      ctl[kStreak] = 0;
      ctl[kWindows] = 1;
      for (int l = 0; l < lanes; ++l) {
        LW(lIt, l) = LW(lTotal, l) = LW(lStreak, l) = 0;
        LW(lWindows, l) = 1;
        LW(lActive, l) = LW(lPassLive, l) && limit > 0;
        any |= LW(lActive, l);
      }
      cudaGraphSetConditional(handle, (lanes ? any : limit > 0) ? 1u : 0u);
      break;
    case kPhaseCond:
      if (lanes) {
        ctl[kIt] += 1;  // the body's trips: the longest-running lane's rounds
        for (int l = 0; l < lanes; ++l) {
          LW(lActive, l) = LW(lActive, l) && LW(lStreak, l) < LW(lWindows, l) && LW(lIt, l) < limit;
          any |= LW(lActive, l);
        }
        cudaGraphSetConditional(handle, any);
      } else {
        cudaGraphSetConditional(handle, ctl[kStreak] < ctl[kWindows] && ctl[kIt] < limit ? 1u : 0u);
      }
      break;
    case kPhaseEnd:
      if (lanes) {
        ctl[kTotal] = 0;
        for (int l = 0; l < lanes; ++l) {
          LW(lRounds, l) += LW(lIt, l);
          LW(lMoves, l) += LW(lTotal, l);
          LW(lPassMoves, l) += LW(lTotal, l);
          ctl[kTotal] += LW(lTotal, l);
        }
      }
      ctl[kRounds] += ctl[kIt];
      ctl[kMoves] += ctl[kTotal];
      ctl[kPassMoves] += ctl[kTotal];
      ctl[kTrips + phase] += ctl[kIt];
      break;
    case kPassEnd:
      ctl[kPasses] += 1;
      if (lanes) {
        for (int l = 0; l < lanes; ++l) {
          LW(lPasses, l) += LW(lPassLive, l);
          LW(lPassLive, l) = LW(lPassLive, l) && LW(lPassMoves, l) > 0 && LW(lPasses, l) < limit;
          any |= LW(lPassLive, l);
        }
        cudaGraphSetConditional(handle, any);
      } else {
        cudaGraphSetConditional(handle, ctl[kPassMoves] > 0 && ctl[kPasses] < limit ? 1u : 0u);
      }
      break;
  }
#undef LW
  ctl[kCtlRuns] += 1;
}

enum CountSlot { kStep = 0, kCountRuns };
enum CountOp { kCountInit = 0, kCountNext };

__global__ void count_ctl(int op, int* ctl, cudaGraphConditionalHandle handle, int trips) {
  if (op == kCountInit) {
    ctl[kStep] = 0;
    ctl[kCountRuns] = 0;
  } else {
    ctl[kStep] += 1;
  }
  cudaGraphSetConditional(handle, ctl[kStep] < trips ? 1u : 0u);
  ctl[kCountRuns] += 1;
}

int add_count_ctl(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep, int op, int* ctl,
                  cudaGraphConditionalHandle handle, int trips) {
  cudaKernelNodeParams p = {};
  void* args[] = {&op, &ctl, &handle, &trips};
  p.func = (void*)count_ctl;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  return (int)cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

struct Lanes {
  int count;  // 0: one cluster
  int* words;
};

int add_ctl(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep, int op, int* ctl,
            cudaGraphConditionalHandle handle, int phase, int limit, int nphases, Lanes ln) {
  cudaKernelNodeParams p = {};
  void* args[] = {&op, &ctl, &handle, &phase, &limit, &nphases, &ln.count, &ln.words};
  p.func = (void*)loop_ctl;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  return (int)cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

// A WHILE node on `handle` after `dep`; its body graph goes to *body.
int add_while(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
              cudaGraphConditionalHandle handle, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  const int err = (int)cudaGraphAddNode(node, graph, dep, dep ? 1 : 0, &p);
  if (!err) *body = p.conditional.phGraph_out[0];
  return err;
}

}  // namespace

// Plain C entry points for ctypes; each returns 0 or the first CUDA error.

// out: the runtime's and the driver's CUDA versions (1000 * major + 10 * minor).
extern "C" int cc_loop_versions(long long* out) {
  int rt = 0, drv = 0;
  int err = (int)cudaRuntimeGetVersion(&rt);
  if (!err) err = (int)cudaDriverGetVersion(&drv);
  out[0] = rt;
  out[1] = drv;
  return err;
}

// Build and instantiate one goal graph.  args: ctl (device int32 pointer), max_passes,
// nphases, lanes (0: one cluster), lane (device int32 pointer of kLaneWords x lanes words, or
// 0), then per phase: its captured round (a cudaGraph_t, cloned into the body) and its round
// cap.  out: the graph and its executable.
extern "C" int cc_loop_build(const long long* args, long long* out) {
  int* ctl = (int*)args[0];
  const int max_passes = (int)args[1], nphases = (int)args[2];
  const Lanes ln = {(int)args[3], (int*)args[4]};
  args += 2;  // the phases follow the lane arguments
  if (!ctl || nphases <= 0 || nphases > kMaxPhases || max_passes <= 0 || ln.count < 0 ||
      (ln.count > 0 && !ln.words))
    return (int)cudaErrorInvalidValue;
  cudaGraph_t graph = nullptr;
  int err = (int)cudaGraphCreate(&graph, 0);
  if (err) return err;
  cudaGraphNode_t init, pass_node, prev, node;
  cudaGraph_t pass_body = nullptr;
  cudaGraphConditionalHandle pass_handle;
  err = add_ctl(&init, graph, nullptr, kGoalInit, ctl, 0, 0, 0, nphases, ln);
  if (!err)
    err = (int)cudaGraphConditionalHandleCreate(&pass_handle, graph, 1, cudaGraphCondAssignDefault);
  if (!err) err = add_while(&pass_node, graph, &init, pass_handle, &pass_body);
  if (!err) err = add_ctl(&prev, pass_body, nullptr, kPassInit, ctl, 0, 0, 0, nphases, ln);
  for (int k = 0; k < nphases && !err; ++k) {
    const cudaGraph_t round = (cudaGraph_t)args[3 + 2 * k];
    const int max_rounds = (int)args[4 + 2 * k];
    cudaGraphConditionalHandle h;
    cudaGraph_t body = nullptr;
    cudaGraphNode_t phase_init, loop, child, cond;
    err = (int)cudaGraphConditionalHandleCreate(&h, pass_body, 0, 0);
    if (!err) err = add_ctl(&phase_init, pass_body, &prev, kPhaseInit, ctl, h, k, max_rounds, nphases, ln);
    if (!err) err = add_while(&loop, pass_body, &phase_init, h, &body);
    if (!err) err = (int)cudaGraphAddChildGraphNode(&child, body, nullptr, 0, round);
    if (!err) err = add_ctl(&cond, body, &child, kPhaseCond, ctl, h, k, max_rounds, nphases, ln);
    if (!err) err = add_ctl(&prev, pass_body, &loop, kPhaseEnd, ctl, 0, k, 0, nphases, ln);
  }
  if (!err) err = add_ctl(&node, pass_body, &prev, kPassEnd, ctl, pass_handle, 0, max_passes, nphases, ln);
  cudaGraphExec_t exec = nullptr;
  if (!err) err = (int)cudaGraphInstantiate(&exec, graph, 0);
  if (err) {
    cudaGraphDestroy(graph);
    return err;
  }
  out[0] = (long long)graph;
  out[1] = (long long)exec;
  return 0;
}

// Build and instantiate one counted loop.  args: ctl (device int32 pointer), trips, the
// captured step (a cudaGraph_t, cloned into the body).  out: the graph and its executable.
extern "C" int cc_count_loop_build(const long long* args, long long* out) {
  int* ctl = (int*)args[0];
  const int trips = (int)args[1];
  const cudaGraph_t step = (cudaGraph_t)args[2];
  if (!ctl || trips < 0 || !step) return (int)cudaErrorInvalidValue;
  cudaGraph_t graph = nullptr;
  int err = (int)cudaGraphCreate(&graph, 0);
  if (err) return err;
  cudaGraphConditionalHandle h;
  cudaGraph_t body = nullptr;
  cudaGraphNode_t init, loop, child, next;
  err = (int)cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (!err) err = add_count_ctl(&init, graph, nullptr, kCountInit, ctl, h, trips);
  if (!err) err = add_while(&loop, graph, &init, h, &body);
  if (!err) err = (int)cudaGraphAddChildGraphNode(&child, body, nullptr, 0, step);
  if (!err) err = add_count_ctl(&next, body, &child, kCountNext, ctl, h, trips);
  cudaGraphExec_t exec = nullptr;
  if (!err) err = (int)cudaGraphInstantiate(&exec, graph, 0);
  if (err) {
    cudaGraphDestroy(graph);
    return err;
  }
  out[0] = (long long)graph;
  out[1] = (long long)exec;
  return 0;
}

// The work nodes of a captured graph (kernels, memsets, copies; child graphs counted
// through): what the device runs each time the graph runs.  args: graph.  out: the count.
extern "C" int cc_graph_work_nodes(const long long* args, long long* out) {
  const cudaGraph_t graph = (cudaGraph_t)args[0];
  size_t n = 0;
  int err = (int)cudaGraphGetNodes(graph, nullptr, &n);
  if (err) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n > 0 ? n : 1];
  err = (int)cudaGraphGetNodes(graph, nodes, &n);
  long long count = 0;
  for (size_t i = 0; i < n && !err; ++i) {
    cudaGraphNodeType type;
    err = (int)cudaGraphNodeGetType(nodes[i], &type);
    if (err) break;
    if (type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemset ||
        type == cudaGraphNodeTypeMemcpy) {
      ++count;
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      long long sub = 0;
      err = (int)cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      const long long child_args[1] = {(long long)child};
      if (!err) err = cc_graph_work_nodes(child_args, &sub);
      count += sub;
    }
  }
  delete[] nodes;
  *out = count;
  return err;
}

// args: executable, stream.
extern "C" int cc_loop_launch(const long long* args) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)args[0], (cudaStream_t)args[1]);
}

// args: graph, executable.
extern "C" int cc_loop_destroy(const long long* args) {
  int err = (int)cudaGraphExecDestroy((cudaGraphExec_t)args[1]);
  const int err2 = (int)cudaGraphDestroy((cudaGraph_t)args[0]);
  return err ? err : err2;
}
