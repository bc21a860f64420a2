// Static-key round placer: K job sections x M placements in one launch.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_place.py
// `_batch_kernel` (built by `make_round_placer`, placement step
// `_make_attempt`, score `_dyn_score`), with its pod-affinity extension
// (`_read_aff_env`, `_aff_eval`, `_aff_commit`) when the launch carries the
// affinity arguments. The plain PyTorch version of the same function, and
// the argument order, are in volcano_tpu_torch/ops/round_placer.py.
//
// Design (simple and right first):
// - One thread block of BLOCK threads runs the whole launch. It walks the
//   K*M placement attempts in order, because every attempt reads the
//   capacity the previous one committed.
// - The node-axis state (idle, pipe [R, N], pods [1, N], GPU cards [G, N],
//   and with pod affinity the counts cnt [SK, N], tot [SK, 1], anti
//   [ETA, N]) lives in global memory: about 200 KB at N = 10240 without
//   affinity, about 1.2 MB more at BASELINE configuration 5 (SK = 16,
//   ETA = 8, and the static domain rows), so it stays in L2. The kernel
//   first copies the input state to the output buffers and then updates
//   the outputs in place.
// - Each attempt is the shared placement step of placement.cuh: with pod
//   affinity a first block pass (mask, raw preferred score, its max and
//   min over the live nodes), then the block argmax over the node axis;
//   thread 0 commits the chosen node's column and writes the slot outputs,
//   and the block adds the placement's affinity rows. __syncthreads()
//   separates attempts.
// - A gang discard restores the saved old values of the (at most M) columns
//   the section touched, newest first, and takes the section's affinity
//   rows back, newest first (exact: integer-valued counts, placement.cuh).
//
// What bounds it: not bytes and not arithmetic (a launch moves a few
// megabytes and does some 10^8 float operations, microseconds of either
// on an H100) but a serial chain of K*M = 128 dependent block-wide
// reductions (two per attempt with pod affinity), each with its barriers,
// run by one SM while the other 131 idle. A later version can spread the
// node axis of one launch over a thread-block cluster whose distributed
// shared memory holds the state (one reduction over up to 16 SMs per
// attempt), and keep the per-template rows in shared memory instead of L2.

#include "placement.cuh"

namespace {

using namespace placement;

// pointer slots of round_placer_launch: the inputs in the order of
// round_placer.PlacerArgs, then the outputs, then the scratch row pair
enum Ptr {
  P_RESREQ, P_GPU_REQ, P_PREF, P_SUFFIX, P_TMPL, P_GRP, P_VOLN, P_VOLOK,
  P_REV, P_ACTIVE, P_READY0, P_MINAV, P_CANB, P_SECACT, P_ISTGT, P_TSTAT,
  P_TSCORE, P_NASCORE, P_BLOCKNR, P_BLOCKALL, P_BONUS, P_LOCKED, P_ORFEAS,
  P_RELMP, P_ALLOC, P_CNT, P_MAXP, P_GIDLE0, P_LIVE, P_SKDOM, P_SK_SEL,
  P_ETA_SK, P_ETA_DOM, P_STATIC_PREF, P_AFF_SK, P_ANTI, P_PREFSK, P_PREFW,
  P_SKM, P_ETM, P_SELM, P_IDLE, P_PIPE, P_PODS, P_GPUX, P_AFF_CNT, P_AFF_TOT,
  P_ANTI_CNT,
  // outputs
  O_NODE, O_MODE, O_GPU, O_IDLE, O_PIPE, O_PODS, O_GPUX, O_AFF_CNT,
  O_AFF_TOT, O_ANTI_CNT,
  SCRATCH,
  N_PTRS
};

// integer dimensions and flags of round_placer_launch
enum Dim { D_K, D_M, D_N, D_R, D_G, D_GANG, D_PIPELINING, D_AFF, D_SK, D_ETA,
           D_SEL, D_A, D_B, D_PP, N_DIMS };

struct Args {
  NodeEnv env;
  SlotEnv slots;
  AffEnv aff;
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
  const float* cnt_in;
  const float* tot_in;
  const float* anti_in;
  // outputs
  int* node_o;
  int* mode_o;
  int* gpu_o;
  int K, M, gang, has_aff;
};

__global__ void __launch_bounds__(BLOCK)
    round_placer_kernel(const __grid_constant__ Args a) {
  const int tid = threadIdx.x;
  const NodeEnv& e = a.env;
  const AffEnv& ae = a.aff;
  const bool aff = a.has_aff != 0;
  const int R = e.R, G = e.G, M = a.M, K = a.K, N = e.N;
  const int KM = K * M;

  extern __shared__ float smem[];
  const SaveArea save{reinterpret_cast<int*>(smem), smem + M, 2 * R + 1 + G};
  __shared__ PickShared ps;
  __shared__ AffShared as;
  __shared__ float aff_red[2 * WARPS];
  __shared__ int sec_stopped, sec_broke, sec_nalloc, sec_npipe, sec_nsave,
      sec_keep;
  if (aff && tid == 0)
    aff_bind(as, reinterpret_cast<int*>(smem + M + M * save.stride), ae);

  copy_state(e, a.idle_in, a.pipe_in, a.pods_in, a.gpux_in);
  if (aff) copy_aff(ae, N, a.cnt_in, a.tot_in, a.anti_in);
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
        if (aff) aff_eval(ae, N, s, as, aff_red);
        const Pick pk = block_pick(e, t, is_tgt, ps, aff ? &ae : nullptr, &as);
        if (tid == 0) {
          const bool do_alloc = pk.any_now;
          const bool do_pipe = !pk.any_now && pk.any_fut && e.pipelining;
          const bool placed = do_alloc || do_pipe;
          as.node = -1;
          if (placed) {
            const int node = do_alloc ? pk.node_now : pk.node_fut;
            const int card = commit(e, t, node, do_alloc, save, sec_nsave++);
            a.node_o[s] = node;
            a.mode_o[s] = do_alloc ? MODE_ALLOCATED : MODE_PIPELINED;
            a.gpu_o[s] = card;
            as.node = node;
          }
          sec_nalloc += do_alloc ? 1 : 0;
          sec_npipe += do_pipe ? 1 : 0;
          const bool ready_aft =
              !a.gang || (a.ready0[k] + sec_nalloc) >= a.minav[k];
          if (placed && ready_aft && a.suffix[s] > 0 && !(a.canb[k] > 0))
            sec_stopped = 1;
          if (!placed) sec_broke = 1;
        }
        if (aff) {
          __syncthreads();
          if (as.node >= 0) aff_apply(ae, N, s, as.node, 1.0f, as, true);
        }
      }
      __syncthreads();
    }

    // gang finalize: JobReady / JobPipelined keep the section, else Discard
    if (tid == 0) {
      const bool ready = !a.gang || (a.ready0[k] + sec_nalloc) >= a.minav[k];
      const bool pipelined =
          (a.ready0[k] + sec_nalloc + sec_npipe) >= a.minav[k];
      sec_keep = ready || pipelined;
    }
    __syncthreads();
    if (!sec_keep) {
      if (aff)
        for (int s = (k + 1) * M - 1; s >= k * M; --s)
          if (a.mode_o[s] != MODE_NONE)
            aff_apply(ae, N, s, a.node_o[s], -1.0f, as, false);
      if (tid == 0) {
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

// ptrs: the inputs in the order of round_placer.PlacerArgs, then the 10
// outputs, then the [2, N] scratch (null where a part is off); dims: see
// Dim; weights: binpack, least, most, balanced, pod affinity.
extern "C" int round_placer_launch(void* const* ptrs, const int* dims,
                                   const float* weights, void* stream) {
  const int K = dims[D_K], M = dims[D_M], N = dims[D_N], R = dims[D_R],
            G = dims[D_G], has_aff = dims[D_AFF];
  if (R < 1 || R > MAX_R || K < 1 || M < 1 || N < 1 || G < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto F = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto I = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto FO = [&](int i) { return static_cast<float*>(ptrs[i]); };
  auto IO = [&](int i) { return static_cast<int*>(ptrs[i]); };
  Args a;
  a.env = NodeEnv{F(P_TSTAT), F(P_TSCORE), F(P_NASCORE), F(P_BLOCKNR),
                  F(P_BLOCKALL), F(P_BONUS), F(P_LOCKED), F(P_ORFEAS),
                  F(P_RELMP), F(P_ALLOC), F(P_CNT), F(P_MAXP), F(P_GIDLE0),
                  FO(O_IDLE), FO(O_PIPE), FO(O_PODS), FO(O_GPUX), N, R, G,
                  dims[D_PIPELINING], weights[0], weights[1], weights[2],
                  weights[3]};
  a.slots = SlotEnv{F(P_RESREQ), F(P_GPU_REQ), I(P_PREF), I(P_TMPL),
                    I(P_GRP), I(P_VOLN), I(P_VOLOK), I(P_REV), K * M};
  a.aff = AffEnv{F(P_LIVE), I(P_SKDOM), I(P_SK_SEL), I(P_ETA_SK),
                 I(P_ETA_DOM), F(P_STATIC_PREF), I(P_AFF_SK), I(P_ANTI),
                 I(P_PREFSK), F(P_PREFW), F(P_SKM), F(P_ETM), F(P_SELM),
                 FO(O_AFF_CNT), FO(O_AFF_TOT), FO(O_ANTI_CNT), FO(SCRATCH),
                 FO(SCRATCH) + N, dims[D_SK], dims[D_ETA], dims[D_SEL],
                 dims[D_A], dims[D_B], dims[D_PP], K * M, weights[4]};
  a.suffix = I(P_SUFFIX);
  a.active = I(P_ACTIVE);
  a.ready0 = I(P_READY0);
  a.minav = I(P_MINAV);
  a.canb = I(P_CANB);
  a.secact = I(P_SECACT);
  a.istgt = I(P_ISTGT);
  a.idle_in = F(P_IDLE);
  a.pipe_in = F(P_PIPE);
  a.pods_in = F(P_PODS);
  a.gpux_in = F(P_GPUX);
  a.cnt_in = F(P_AFF_CNT);
  a.tot_in = F(P_AFF_TOT);
  a.anti_in = F(P_ANTI_CNT);
  a.node_o = IO(O_NODE);
  a.mode_o = IO(O_MODE);
  a.gpu_o = IO(O_GPU);
  a.K = K;
  a.M = M;
  a.gang = dims[D_GANG];
  a.has_aff = has_aff;
  int list_ints = 0;
  if (has_aff) {
    const AffEnv& ae = a.aff;
    if (ae.SK < 1 || ae.ETA < 1 || ae.SEL < 1 || ae.A < 1 || ae.B < 1 ||
        ae.PP < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    list_ints = aff_list_ints(ae.SK, ae.ETA, ae.SEL, ae.A, ae.B, ae.PP);
  }
  const size_t smem =
      (static_cast<size_t>(M) * (2 * R + G + 2) + list_ints) * sizeof(float);
  round_placer_kernel<<<1, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
