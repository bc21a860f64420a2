// Static-key round placer: K job sections x M placements in one launch.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_place.py
// `_batch_kernel` (built by `make_round_placer`, placement step
// `_make_attempt`, score `_dyn_score`), with its pod-affinity extension
// (`_read_aff_env`, `_aff_eval`, `_aff_commit`) when the launch carries the
// affinity arguments. The plain PyTorch version of the same function, and
// the argument order, are in volcano_tpu_torch/ops/round_placer.py.
//
// What bounds it: not bytes and not arithmetic (a launch moves a few
// megabytes and does some 10^8 float operations, microseconds of either
// on an H100) but a serial chain of K*M = 128 dependent attempts, each an
// evaluation of the node axis and a reduction over it (two with pod
// affinity). On one SM an attempt walks all N nodes (about 26 us at N =
// 10,240); spread over CB SMs it walks N / CB.
//
// Design: one thread-block cluster of CB blocks (8 or 16) spreads the node
// axis over CB SMs, launched with cudaLaunchKernelEx and the cluster
// dimension attribute.
// - Block r owns the contiguous nodes [r * cap, min((r + 1) * cap, N)),
//   cap = ceil(N / CB): the last slice may be shorter, and blocks past N
//   own none (they still take part in every exchange).
// - Block r keeps its slice of the live state (idle, pipe [R, cap], pods,
//   GPU cards [G, cap]) in its own shared memory for the whole launch,
//   reading it from the inputs at the start and writing it to the outputs
//   at the end; about 13 KB a block at N = 10,240, R = 2 and CB = 16. The
//   static rows stay in global memory (L2), each block reading its slice.
// - Each attempt: every block evaluates its slice with placement.cuh's row
//   code (node_eval, block_pick's), then one cluster exchange
//   (cluster_pick) gives every block the same pick, the one-block pick.
//   Every block keeps the same section bookkeeping from it (allocations,
//   pipelines, stop, break, keep or discard). The block that owns the
//   chosen node commits its column, picks the GPU card and saves the old
//   column in its shared memory.
// - A gang discard: each block restores the columns it saved, newest
//   first, and takes back its slice of the affinity rows.
// - The slot outputs are written once a section: node and mode by block 0,
//   the GPU card by the block that owns the chosen node (block 0 where
//   nothing stays placed).
// - Pod affinity: the counts cnt [SK, N] and anti [ETA, N] are global
//   memory, each block reading and writing its slice; each block keeps a
//   replica of tot [SK] in shared memory and applies the same
//   integer-valued deltas to it. The raw preferred score's max and min over
//   the live nodes are a second exchange in the same attempt.
// - The exchange partials are double-buffered by the parity of the
//   launch's exchange count, so one cluster barrier an exchange is enough.
//   The design's latency floor is K*M attempts x (one exchange, plus one
//   more with pod affinity); chip_smoke.py phase 6 measures an exchange.
// - A card that cannot place the cluster makes the launch fail: there is
//   no other design to fall back to.

#include <cooperative_groups.h>

#include "placement.cuh"

namespace {

using namespace placement;

// static shared memory the kernels may keep: ops/round_placer.py's
// MAX_SHARED leaves this much of a block's 232,448 bytes for it
constexpr size_t STATIC_SHARED = 2048;

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
           D_SEL, D_A, D_B, D_PP, D_CB, N_DIMS };

struct Args {
  NodeEnv env;           // idle, pipe, pods, gpux: the output buffers
  SlotEnv slots;
  AffEnv aff;            // tot: the output buffer
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

// 4-byte words of dynamic shared memory of one block: the live state's
// slice [2R + 1 + G, cap], the saved columns of one section (node ids and
// values [M, 2R + 1 + G]), the section's node, mode and card [M], the tot
// replica [SK] and one attempt's affinity term lists (ops/round_placer.py
// shared_bytes computes the same)
inline size_t smem_words(int cap, int M, int R, int G, int SK,
                         int list_ints) {
  const size_t col = 2 * R + 1 + G;
  return col * cap + M * (col + 1) + 3 * M + SK + list_ints;
}

__global__ void __launch_bounds__(CBLOCK)
    round_placer_kernel(const __grid_constant__ Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const NodeEnv& e = a.env;
  const bool aff = a.has_aff != 0;
  const int R = e.R, G = e.G, M = a.M, K = a.K, N = e.N;
  const int CB = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cap = (N + CB - 1) / CB;
  const int lo = min(rank * cap, N), hi = min(lo + cap, N);
  const int col = 2 * R + 1 + G;

  extern __shared__ float smem[];
  float* st = smem;
  const LiveView lv{st, st + R * cap, st + 2 * R * cap,
                    st + (2 * R + 1) * cap, cap, lo};
  int* save_node = reinterpret_cast<int*>(st + col * cap);
  const SaveArea save{save_node, reinterpret_cast<float*>(save_node + M),
                      col};
  int* sec_node = reinterpret_cast<int*>(save.val + M * col);
  int* sec_mode = sec_node + M;
  int* sec_card = sec_mode + M;
  float* tot = reinterpret_cast<float*>(sec_card + M);
  int* lists = reinterpret_cast<int*>(tot + (aff ? a.aff.SK : 0));
  __shared__ ClusterSlot slots[2];
  __shared__ PickShared ps;
  __shared__ AffShared as;
  __shared__ float aff_red[2 * WARPS];
  __shared__ int sec_stopped, sec_broke, sec_nalloc, sec_npipe, sec_nsave,
      sec_keep;
  static_assert(sizeof(slots) + sizeof(ps) + sizeof(as) + sizeof(aff_red) +
                        6 * sizeof(int) <=
                    STATIC_SHARED,
                "static shared memory over the allowance MAX_SHARED leaves");
  int xc = 0;  // exchanges so far: its parity picks the slot buffer

  // this block's affinity view: the counts in global memory, tot its replica
  AffEnv ae = a.aff;
  ae.tot = tot;
  if (aff && tid == 0) aff_bind(as, lists, ae);

  // this block's slice of the input state
  load_slice(e, {a.idle_in, a.pipe_in, a.pods_in, a.gpux_in}, st, cap, lo,
             hi);
  if (aff) {
    for (int k = 0; k < ae.SK; ++k)
      for (int i = lo + tid; i < hi; i += CBLOCK)
        ae.cnt[k * N + i] = a.cnt_in[k * N + i];
    for (int k = 0; k < ae.ETA; ++k)
      for (int i = lo + tid; i < hi; i += CBLOCK)
        ae.anti_cnt[k * N + i] = a.anti_in[k * N + i];
    for (int k = tid; k < ae.SK; k += CBLOCK) tot[k] = a.tot_in[k];
  }

  for (int k = 0; k < K; ++k) {
    if (tid == 0) {
      sec_stopped = 0;
      sec_broke = 0;
      sec_nalloc = 0;
      sec_npipe = 0;
      sec_nsave = 0;
    }
    for (int m = tid; m < M; m += CBLOCK) {
      sec_node[m] = -1;
      sec_mode[m] = MODE_NONE;
      sec_card[m] = -1;
    }
    __syncthreads();
    const bool sec_act = a.secact[k] > 0;
    const bool is_tgt = a.istgt[k] > 0;
    for (int m = 0; m < M; ++m) {
      const int s = k * M + m;
      // uniform over the cluster: every block keeps the same flags
      const bool active =
          a.active[s] > 0 && sec_act && !sec_stopped && !sec_broke;
      if (active) {
        const Task t = load_task(a.slots, e, s);
        if (aff)
          cluster_aff_eval(cluster, ae, N, s, as, aff_red, lo, hi,
                           &slots[xc++ & 1]);
        const Pick pk = cluster_pick(cluster, e, lv, t, is_tgt, ps, lo, hi,
                                     &slots[xc++ & 1], aff ? &ae : nullptr,
                                     &as);
        if (tid == 0) {
          const bool do_alloc = pk.any_now;
          const bool do_pipe = !pk.any_now && pk.any_fut && e.pipelining;
          const bool placed = do_alloc || do_pipe;
          as.node = -1;
          if (placed) {
            const int node = do_alloc ? pk.node_now : pk.node_fut;
            sec_node[m] = node;
            sec_mode[m] = do_alloc ? MODE_ALLOCATED : MODE_PIPELINED;
            if (node >= lo && node < hi)
              sec_card[m] = commit(e, lv, t, node, do_alloc, save,
                                   sec_nsave++);
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
          if (as.node >= 0)
            aff_apply(ae, N, s, as.node, 1.0f, as, true, lo, hi, CBLOCK);
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
        for (int m = M - 1; m >= 0; --m)
          if (sec_mode[m] != MODE_NONE)
            aff_apply(ae, N, k * M + m, sec_node[m], -1.0f, as, false, lo,
                      hi, CBLOCK);
      if (tid == 0) restore(e, lv, save, sec_nsave);
    }
    // the section's slot outputs, each written by one block
    for (int m = tid; m < M; m += CBLOCK) {
      const int j = k * M + m;
      const int node = sec_keep ? sec_node[m] : -1;
      if (rank == 0) {
        a.node_o[j] = node;
        a.mode_o[j] = node >= 0 ? sec_mode[m] : MODE_NONE;
      }
      if (rank == (node >= 0 ? node / cap : 0))
        a.gpu_o[j] = node >= 0 ? sec_card[m] : -1;
    }
    __syncthreads();
  }

  // this block's slice of the final state
  store_slice(e, st, cap, lo, hi);
  if (aff && rank == 0)
    for (int k = tid; k < ae.SK; k += CBLOCK) a.aff.tot[k] = tot[k];
  // no block leaves while another may still read its exchange slots
  cluster.sync();
}

// The cluster exchange alone, `iters` times: each block writes a slot, one
// cluster barrier, warp 0 reads the CB slots (the pick's exchange, with no
// node evaluation). Block 0 writes the last merged pick to `out`.
__global__ void __launch_bounds__(CBLOCK) exchange_probe_kernel(int iters,
                                                                int* out) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ ClusterSlot slots[2];
  const int rank = static_cast<int>(cluster.block_rank());
  ClusterSlot w{};
  for (int x = 0; x < iters; ++x) {
    ClusterSlot* slot = &slots[x & 1];
    if (threadIdx.x == 0) {
      slot->s[0] = slot->s[1] = static_cast<float>((rank * 7 + x) % 5);
      slot->i[0] = slot->i[1] = rank;
      slot->any = 1;
    }
    cluster.sync();
    if (threadIdx.x < 32) w = exchange_pick(cluster, slot, MAX_CB);
  }
  if (rank == 0 && threadIdx.x == 0) out[0] = w.i[0];
  cluster.sync();
}

}  // namespace

// ptrs: the inputs in the order of round_placer.PlacerArgs, then the 10
// outputs, then the [2, N] scratch (null where a part is off); dims: see
// Dim; weights: binpack, least, most, balanced, pod affinity. Returns 0,
// a CUDA error code, NO_CLUSTER or STATIC_OVER.
extern "C" int round_placer_launch(void* const* ptrs, const int* dims,
                                   const float* weights, void* stream) {
  const int K = dims[D_K], M = dims[D_M], N = dims[D_N], R = dims[D_R],
            G = dims[D_G], has_aff = dims[D_AFF], CB = dims[D_CB];
  if (R < 1 || R > MAX_R || K < 1 || M < 1 || N < 1 || G < 0 || CB < 1 ||
      CB > MAX_CB)
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
  int list_ints = 0, SK = 0;
  if (has_aff) {
    const AffEnv& ae = a.aff;
    if (ae.SK < 1 || ae.ETA < 1 || ae.SEL < 1 || ae.A < 1 || ae.B < 1 ||
        ae.PP < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    list_ints = aff_list_ints(ae.SK, ae.ETA, ae.SEL, ae.A, ae.B, ae.PP);
    SK = ae.SK;
  }
  const int cap = (N + CB - 1) / CB;
  const size_t smem = smem_words(cap, M, R, G, SK, list_ints) * 4;
  return launch_cluster(round_placer_kernel, CB, smem, STATIC_SHARED,
                        static_cast<cudaStream_t>(stream), a);
}

// `iters` cluster exchanges of CB blocks (exchange_probe_kernel); `out`
// int32[1]. Returns as round_placer_launch.
extern "C" int exchange_probe_launch(int CB, int iters, void* out,
                                     void* stream) {
  if (CB < 1 || CB > MAX_CB || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(exchange_probe_kernel, CB, 0, STATIC_SHARED,
                        static_cast<cudaStream_t>(stream), iters,
                        static_cast<int*>(out));
}
