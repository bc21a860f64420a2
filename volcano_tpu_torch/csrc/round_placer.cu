// Static-key round placer: K job sections x M placements in one launch.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_place.py
// `_batch_kernel` (built by `make_round_placer`, placement step
// `_make_attempt`, score `_dyn_score`), without the pod-affinity extension.
// The plain PyTorch version of the same function, and the argument order,
// are in volcano_tpu_torch/ops/round_placer.py.
//
// Design (simple and right first):
// - One thread block of BLOCK threads runs the whole launch. It walks the
//   K*M placement attempts in order, because every attempt reads the
//   capacity the previous one committed.
// - The node-axis state (idle, pipe [R, N], pods [1, N], GPU cards [G, N])
//   lives in global memory: about 200 KB at N = 10240, so it stays in L2.
//   The kernel first copies the input state to the output buffers and then
//   updates the outputs in place.
// - Each attempt is the shared placement step of placement.cuh: a block
//   argmax over the node axis, then thread 0 commits the chosen node's
//   column and writes the slot outputs. __syncthreads() separates attempts.
// - A gang discard restores the saved old values of the (at most M) columns
//   the section touched, newest first.
//
// What bounds it: not bytes and not arithmetic (a launch moves about a
// megabyte and does some 10^8 float operations, under a microsecond of
// either on an H100) but a serial chain of K*M = 128 dependent block-wide
// argmax reductions, each with its barriers, run by one SM while the other
// 131 idle. A later version can spread the node axis of one launch over a
// thread-block cluster whose distributed shared memory holds the state
// (one reduction over up to 16 SMs per attempt), and keep the per-template
// rows in shared memory instead of L2.

#include "placement.cuh"

namespace {

using namespace placement;

struct Args {
  NodeEnv env;
  SlotEnv slots;
  const int* suffix;     // [1, KM]
  const int* active;     // [1, KM]
  // per section [1, K]
  const int* ready0;
  const int* minav;
  const int* canb;
  const int* secact;
  const int* istgt;
  // input state
  const float* idle_in;
  const float* pipe_in;
  const float* pods_in;
  const float* gpux_in;
  // outputs
  int* node_o;
  int* mode_o;
  int* gpu_o;
  int K, M, gang;
};

__global__ void __launch_bounds__(BLOCK)
    round_placer_kernel(const __grid_constant__ Args a) {
  const int tid = threadIdx.x;
  const NodeEnv& e = a.env;
  const int R = e.R, G = e.G, M = a.M, K = a.K;
  const int KM = K * M;

  extern __shared__ float smem[];
  const SaveArea save{reinterpret_cast<int*>(smem), smem + M, 2 * R + 1 + G};
  __shared__ PickShared ps;
  __shared__ int sec_stopped, sec_broke, sec_nalloc, sec_npipe, sec_nsave;

  copy_state(e, a.idle_in, a.pipe_in, a.pods_in, a.gpux_in);
  for (int j = tid; j < KM; j += BLOCK) {
    a.node_o[j] = -1;
    a.mode_o[j] = MODE_NONE;
    a.gpu_o[j] = -1;
  }

  for (int k = 0; k < K; ++k) {
    if (tid == 0) {
      sec_stopped = 0;
      sec_broke = 0;
      sec_nalloc = 0;
      sec_npipe = 0;
      sec_nsave = 0;
    }
    __syncthreads();
    const bool sec_act = a.secact[k] > 0;
    const bool is_tgt = a.istgt[k] > 0;
    for (int m = 0; m < M; ++m) {
      const int s = k * M + m;
      // uniform over the block: every thread reads the same shared flags
      const bool active =
          a.active[s] > 0 && sec_act && !sec_stopped && !sec_broke;
      if (active) {
        const Task t = load_task(a.slots, e, s);
        const Pick pk = block_pick(e, t, is_tgt, ps);
        if (tid == 0) {
          const bool do_alloc = pk.any_now;
          const bool do_pipe = !pk.any_now && pk.any_fut && e.pipelining;
          const bool placed = do_alloc || do_pipe;
          if (placed) {
            const int node = do_alloc ? pk.node_now : pk.node_fut;
            const int card = commit(e, t, node, do_alloc, save, sec_nsave++);
            a.node_o[s] = node;
            a.mode_o[s] = do_alloc ? MODE_ALLOCATED : MODE_PIPELINED;
            a.gpu_o[s] = card;
          }
          sec_nalloc += do_alloc ? 1 : 0;
          sec_npipe += do_pipe ? 1 : 0;
          const bool ready_aft =
              !a.gang || (a.ready0[k] + sec_nalloc) >= a.minav[k];
          if (placed && ready_aft && a.suffix[s] > 0 && !(a.canb[k] > 0))
            sec_stopped = 1;
          if (!placed) sec_broke = 1;
        }
      }
      __syncthreads();
    }

    // gang finalize: JobReady / JobPipelined keep the section, else Discard
    if (tid == 0) {
      const bool ready = !a.gang || (a.ready0[k] + sec_nalloc) >= a.minav[k];
      const bool pipelined =
          (a.ready0[k] + sec_nalloc + sec_npipe) >= a.minav[k];
      if (!(ready || pipelined)) {
        restore(e, save, sec_nsave);
        for (int j = k * M; j < (k + 1) * M; ++j) {
          a.node_o[j] = -1;
          a.mode_o[j] = MODE_NONE;
          a.gpu_o[j] = -1;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int round_placer_launch(
    const float* resreq, const float* gpu_req, const int* pref,
    const int* suffix, const int* tmpl, const int* grp, const int* voln,
    const int* volok, const int* rev, const int* active, const int* ready0,
    const int* minav, const int* canb, const int* secact, const int* istgt,
    const float* tstat, const float* tscore, const float* nascore,
    const float* blocknr, const float* blockall, const float* bonus,
    const float* locked, const float* orfeas, const float* relmp,
    const float* alloc, const float* cnt, const float* maxp,
    const float* gidle0, const float* idle_in, const float* pipe_in,
    const float* pods_in, const float* gpux_in, int* node_o, int* mode_o,
    int* gpu_o, float* idle, float* pipe, float* pods, float* gpux, int K,
    int M, int N, int R, int G, int gang, int pipelining, float w_bin,
    float w_least, float w_most, float w_bal, void* stream) {
  if (R < 1 || R > MAX_R || K < 1 || M < 1 || N < 1 || G < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.env = NodeEnv{tstat, tscore, nascore, blocknr, blockall, bonus,
                  locked, orfeas, relmp,   alloc,   cnt,      maxp,
                  gidle0, idle,   pipe,    pods,    gpux,     N,
                  R,      G,      pipelining, w_bin, w_least, w_most,
                  w_bal};
  a.slots = SlotEnv{resreq, gpu_req, pref, tmpl, grp, voln, volok, rev,
                    K * M};
  a.suffix = suffix;
  a.active = active;
  a.ready0 = ready0;
  a.minav = minav;
  a.canb = canb;
  a.secact = secact;
  a.istgt = istgt;
  a.idle_in = idle_in;
  a.pipe_in = pipe_in;
  a.pods_in = pods_in;
  a.gpux_in = gpux_in;
  a.node_o = node_o;
  a.mode_o = mode_o;
  a.gpu_o = gpu_o;
  a.K = K;
  a.M = M;
  a.gang = gang;
  const size_t smem = static_cast<size_t>(M) * (2 * R + G + 2) * sizeof(float);
  round_placer_kernel<<<1, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
