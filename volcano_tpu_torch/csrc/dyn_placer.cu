// Dynamic-key round placer: up to KP job pops over C candidate jobs in one
// launch, the ordering keys recomputed after every gang commit.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_place.py
// `_dyn_kernel` (built by `make_dyn_round_placer`), with its pod-affinity
// extension (`_read_aff_env`, `_aff_eval`, `_aff_commit`) when the launch
// carries the affinity arguments. The plain PyTorch version of the same
// function, the argument order and the key plan are in
// volcano_tpu_torch/ops/dyn_placer.py.
//
// Design (simple and right first):
// - One thread block of BLOCK threads runs the whole launch, because every
//   pop reads the state the previous one committed. All state lives in
//   global memory (L2): the node columns as in round_placer.cu, and the
//   per-job rows [1, J] / [R, J] and queue allocations [Q, R], which the
//   kernel first copies to its outputs and then updates in place.
// - Per pop: threads q < Q compute each queue's overused flag and share;
//   threads t < S*R fold the namespace allocations over the jobs in job
//   order (the reference's sum over J, in the order the plain version
//   takes); thread j (mod BLOCK) tests job j's eligibility into a per-thread
//   bitmask (up to 32 jobs a thread). The lexicographic argmin is one block
//   min-reduction per key column, each pass also dropping the jobs the
//   previous column excluded, then a block min of the surviving indices.
// - Pop 0 takes the launch's first candidate. Thread 0 checks the stop
//   rules, then the M-slot section runs through the shared placement step
//   of placement.cuh (with pod affinity: the affinity pass, the block
//   argmax, thread 0 commits, the block adds the affinity rows), and
//   thread 0 finalizes the gang (keep, or restore the saved columns newest
//   first after the block took the section's affinity rows back), demotes
//   kept-but-unready placements, and adds the committed resources, folded
//   in slot order, to the job's and its queue's allocation once per pop (no
//   atomics).
//
// What bounds it: as in round_placer.cu, a serial chain of dependent
// block-wide reductions (per pop about ten key columns and M attempts)
// with their barriers, run by one SM; bytes and arithmetic are far below
// the card's rates. The namespace fold is a serial chain of J adds per
// (namespace, dim).

#include "placement.cuh"

namespace {

using namespace placement;

constexpr int MAX_KEYS = 32;
constexpr int KEY_NS = -1, KEY_QSHARE = -2, KEY_READY = -3, KEY_JSHARE = -4;
constexpr int KEY_HCOL = -8;

// pointer slots of dyn_placer_launch: the inputs in the order of
// dyn_placer.DynArgs, then the outputs, then the scratch row pair
enum Ptr {
  P_RESREQ, P_GPU_REQ, P_PREF, P_SUFFIX, P_TMPL, P_GRP, P_VOLN, P_VOLOK,
  P_REV, P_TIDOK, P_NBE, P_CAND, P_CSLOT, P_SKEYS, P_HCOLS, P_QID, P_QOH,
  P_NSM, P_NSC, P_NSW, P_MINAV, P_RDY0, P_NPEND, P_ELIGS, P_VALIDF, P_CANB,
  P_DES, P_QEX, P_TOTAL, P_KMAX, P_TGT, P_TSTAT, P_TSCORE, P_NASCORE,
  P_BLOCKNR, P_BLOCKALL, P_BONUS, P_LOCKED, P_ORFEAS, P_RELMP, P_ALLOC,
  P_CNT, P_MAXP, P_GIDLE0, P_LIVE, P_SKDOM, P_SK_SEL, P_ETA_SK, P_ETA_DOM,
  P_STATIC_PREF, P_AFF_SK, P_ANTI, P_PREFSK, P_PREFW, P_SKM, P_ETM, P_SELM,
  P_IDLE, P_PIPE, P_PODS, P_GPUX, P_AFF_CNT, P_AFF_TOT, P_ANTI_CNT, P_DONE,
  P_POPPED, P_JREADY, P_JPIPE, P_CURSOR, P_ACOUNT, P_JALLOC, P_QALLOC,
  // outputs
  O_NODE, O_MODE, O_GPU, O_IDLE, O_PIPE, O_PODS, O_GPUX, O_AFF_CNT,
  O_AFF_TOT, O_ANTI_CNT, O_DONE, O_POPPED, O_JREADY, O_JPIPE, O_CURSOR,
  O_ACOUNT, O_JALLOC, O_QALLOC, O_POPS, O_PROG,
  SCRATCH,
  N_PTRS
};

// integer dimensions and flags of dyn_placer_launch; the key plan follows
enum Dim { D_C, D_KP, D_M, D_N, D_R, D_G, D_GR, D_J, D_Q, D_S, D_NH, D_NKS,
           D_GANG, D_PIPELINING, D_DRF_NS, D_NKEYS, D_AFF, D_SK, D_ETA, D_SEL,
           D_A, D_B, D_PP, N_DIMS };

struct Args {
  NodeEnv env;
  SlotEnv slots;
  AffEnv aff;
  const int* suffix;   // [1, CM]
  const int* tidok;    // [1, CM]
  const int* nbe;      // [1, CM]
  const int* cand;     // [1, C]
  const int* cslot;    // [1, J]
  const float* skeys;  // [NKS, J]
  const float* hcols;  // [NH, J]
  const int* qid;      // [1, J]
  const float* qoh;    // [Q, J]
  const float* nsm;    // [S, J]
  const float* nsc;    // [S, J]
  const float* nsw;    // [1, S]
  const int* minav;    // [1, J]
  const int* rdy0;
  const int* npend;
  const int* eligs;
  const float* validf;
  const int* canb;
  const float* des;    // [Q, R]
  const float* qex;    // [Q, 1]
  const float* total;  // [R, 1]
  const int* kmax;     // [1, 1]
  const int* tgt;      // [1, 1]
  const float* idle_in;
  const float* pipe_in;
  const float* pods_in;
  const float* gpux_in;
  const int* done_in;
  const int* popped_in;
  const int* jready_in;
  const int* jpipe_in;
  const int* cursor_in;
  const int* acount_in;
  const float* jalloc_in;
  const float* qalloc_in;
  const float* cnt_in;
  const float* tot_in;
  const float* anti_in;
  // outputs
  int* node_o;
  int* mode_o;
  int* gpu_o;
  int* done;
  int* popped;
  int* jready;
  int* jpipe;
  int* cursor;
  int* acount;
  float* jalloc;  // [R, J]
  float* qalloc;  // [Q, R]
  int* pops_o;
  int* prog_o;
  int C, KP, M, J, Q, S, NH, gang, drf_ns, nkeys, has_aff;
  int keys[MAX_KEYS];
};

// jnp.min semantics: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* red, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
    for (int off = 16; off > 0; off >>= 1)
      v = op(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) *out = v;
  }
  __syncthreads();
  return *out;
}

struct MinF {
  __device__ float operator()(float a, float b) const { return min_nan(a, b); }
};
struct MaxF {
  __device__ float operator()(float a, float b) const {
    return (isnan(a) || a > b) ? a : b;
  }
};
struct MinI {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// one key column of job j (the key plan of dyn_placer.key_plan)
__device__ float key_value(const Args& a, int code, int j, const float* qshare,
                           const float* ns_share) {
  const int J = a.J;
  const float EPS_DIV = static_cast<float>(1e-9);
  if (code >= 0) return a.skeys[code * J + j];
  if (code <= KEY_HCOL) return a.hcols[(KEY_HCOL - code) * J + j];
  if (code == KEY_QSHARE) {
    float acc = 0.0f;
    for (int q = 0; q < a.Q; ++q) acc = acc + a.qoh[q * J + j] * qshare[q];
    return acc;
  }
  if (code == KEY_READY)
    return (a.rdy0[j] + a.acount[j] >= a.minav[j] && a.minav[j] > 0) ? 1.0f
                                                                     : 0.0f;
  if (code == KEY_NS) {
    float key = 0.0f;
    for (int s = 0; s < a.S; ++s)
      if (a.nsm[s * J + j] > 0.0f) key = ns_share[s];
    return key;
  }
  if (code == KEY_JSHARE) {
    // the drf dominant share over the live allocation
    if (!(a.validf[j] > 0.0f)) return __int_as_float(0x7f800000);  // +inf
    float share = 0.0f;
    for (int r = 0; r < a.env.R; ++r) {
      const float t = a.total[r];
      const float frac =
          t > 0.0f ? a.jalloc[r * J + j] / fmaxf(t, EPS_DIV) : 0.0f;
      share = r == 0 ? frac : fmaxf(share, frac);
    }
    return share;
  }
  return 0.0f;  // no such code: the wrapper's key plan never sends one
}

__global__ void __launch_bounds__(BLOCK)
    dyn_placer_kernel(const __grid_constant__ Args a) {
  const float EPS_CMP = static_cast<float>(1e-6);
  const float EPS_DIV = static_cast<float>(1e-9);
  const float INF = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const NodeEnv& e = a.env;
  const AffEnv& ae = a.aff;
  const bool aff = a.has_aff != 0;
  const int R = e.R, G = e.G, M = a.M, J = a.J, Q = a.Q, S = a.S, N = e.N;
  const int CM = a.C * M;

  extern __shared__ float smem[];
  const SaveArea save{reinterpret_cast<int*>(smem), smem + M, 2 * R + 1 + G};
  float* over_col = smem + M + M * save.stride;  // [Q]
  float* qshare = over_col + Q;                  // [Q]
  float* ns_alloc = qshare + Q;                  // [S, R]
  float* ns_share = ns_alloc + S * R;            // [S]
  __shared__ PickShared ps;
  __shared__ AffShared as;
  __shared__ float aff_red[2 * WARPS];
  __shared__ float red_f[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ float out_f;
  __shared__ int out_i;
  __shared__ int p_stop, p_jstar, p_off, p_cur0, p_ready0, p_minav, p_canb,
      p_tgt;
  __shared__ int s_stopped, s_broke, s_nalloc, s_npipe, s_nadv, s_nsave,
      s_keep, s_ready, s_pipelined;
  __shared__ int kept_any, prog, pops;

  if (aff && tid == 0)
    aff_bind(as, reinterpret_cast<int*>(ns_share + S), ae);

  // ---- copy the input state to the outputs, updated in place from here
  copy_state(e, a.idle_in, a.pipe_in, a.pods_in, a.gpux_in);
  if (aff) copy_aff(ae, N, a.cnt_in, a.tot_in, a.anti_in);
  for (int j = tid; j < J; j += BLOCK) {
    a.done[j] = a.done_in[j];
    a.popped[j] = a.popped_in[j];
    a.jready[j] = a.jready_in[j];
    a.jpipe[j] = a.jpipe_in[j];
    a.cursor[j] = a.cursor_in[j];
    a.acount[j] = a.acount_in[j];
  }
  for (int j = tid; j < R * J; j += BLOCK) a.jalloc[j] = a.jalloc_in[j];
  for (int j = tid; j < Q * R; j += BLOCK) a.qalloc[j] = a.qalloc_in[j];
  for (int j = tid; j < CM; j += BLOCK) {
    a.node_o[j] = -1;
    a.mode_o[j] = MODE_NONE;
    a.gpu_o[j] = -1;
  }
  if (tid == 0) {
    kept_any = 0;
    prog = 0;
    pops = 0;
  }
  __syncthreads();

  const int kmax = a.kmax[0];
  for (int p = 0; p < a.KP; ++p) {
    // ---- per-queue gate and share, namespace allocations ---------------
    if (tid < Q) {
      float over = 0.0f, share = 0.0f;
      for (int r = 0; r < R; ++r) {
        const float qa = a.qalloc[tid * R + r], d = a.des[tid * R + r];
        if (qa > d + EPS_CMP) over = 1.0f;
        const float v = (isfinite(d) && d > 0.0f) ? qa / fmaxf(d, EPS_DIV)
                                                  : 0.0f;
        share = r == 0 ? v : fmaxf(share, v);
      }
      over_col[tid] = over;
      qshare[tid] = share + a.qex[tid];
    }
    if (a.drf_ns && p > 0 && tid < S * R) {
      // the member jobs' allocations, folded over j in index order
      const int s = tid / R, r = tid % R;
      const float* contrib = a.nsc + s * J;
      const float* row = a.jalloc + r * J;
      float acc = 0.0f;
      for (int j = 0; j < J; ++j)
        acc = acc + (contrib[j] > 0.0f ? row[j] : 0.0f);
      ns_alloc[s * R + r] = acc;
    }
    __syncthreads();
    if (a.drf_ns && p > 0 && tid < S) {
      float share = 0.0f;
      for (int r = 0; r < R; ++r) {
        const float t = a.total[r];
        const float frac =
            t > 0.0f ? ns_alloc[tid * R + r] / fmaxf(t, EPS_DIV) : 0.0f;
        share = r == 0 ? frac : fmaxf(share, frac);
      }
      ns_share[tid] = share / fmaxf(a.nsw[tid], 1.0f);
    }

    // ---- eligibility into a per-thread bitmask --------------------------
    unsigned bits = 0u;
    float qmn = INF, qmx = -INF;
    for (int u = 0, j = tid; j < J; j += BLOCK, ++u) {
      float over = 0.0f;
      for (int q = 0; q < Q; ++q) over = over + a.qoh[q * J + j] * over_col[q];
      if (a.eligs[j] > 0 && a.done[j] == 0 && a.cursor[j] < a.npend[j] &&
          !(over > 0.0f)) {
        bits |= 1u << u;
        const float qf = static_cast<float>(a.qid[j]);
        qmn = fminf(qmn, qf);
        qmx = fmaxf(qmx, qf);
      }
    }
    const bool any_elig = __syncthreads_or(bits != 0u);
    bool guard = false;
    if (a.NH > 0 && kept_any) {
      // hdrf: the frozen columns are exact only while every contender
      // shares one queue once a commit has moved the tree
      const float mn = block_reduce(qmn, MinF(), red_f, &out_f);
      const float mx = block_reduce(qmx, MaxF(), red_f, &out_f);
      guard = mn != mx;
    }

    // ---- lexicographic argmin over the eligible jobs (pops after 0) ----
    int jsel = J;
    if (p > 0 && any_elig) {
      float kmin_prev = 0.0f;
      for (int c = 0; c <= a.nkeys; ++c) {
        float lmin = INF;
        for (int u = 0, j = tid; j < J; j += BLOCK, ++u) {
          if (!((bits >> u) & 1u)) continue;
          if (c > 0 &&
              !(key_value(a, a.keys[c - 1], j, qshare, ns_share) <=
                kmin_prev)) {
            bits &= ~(1u << u);
            continue;
          }
          if (c < a.nkeys)
            lmin = min_nan(lmin, key_value(a, a.keys[c], j, qshare, ns_share));
        }
        if (c < a.nkeys) kmin_prev = block_reduce(lmin, MinF(), red_f, &out_f);
      }
      int lo = J;
      for (int u = 0, j = tid; j < J; j += BLOCK, ++u)
        if ((bits >> u) & 1u) {
          lo = j;
          break;
        }
      jsel = block_reduce(lo, MinI(), red_i, &out_i);
    }

    // ---- the pop and its stop rules (thread 0) ---------------------------
    if (tid == 0) {
      const int jstar = p == 0 ? a.cand[0] : jsel;
      const bool inside = jstar >= 0 && jstar < J;
      const int cs = inside ? a.cslot[jstar] : 0;
      const bool ok = p < kmax && any_elig && !guard && cs >= 0 && inside;
      p_stop = ok ? 0 : 1;
      if (ok) {
        p_jstar = jstar;
        p_off = cs * M;
        p_cur0 = a.cursor[jstar];
        p_ready0 = a.rdy0[jstar] + a.acount[jstar];
        p_minav = a.minav[jstar];
        p_canb = a.canb[jstar] > 0;
        p_tgt = jstar == a.tgt[0];
      }
      s_stopped = 0;
      s_broke = 0;
      s_nalloc = 0;
      s_npipe = 0;
      s_nadv = 0;
      s_nsave = 0;
    }
    __syncthreads();
    if (p_stop) break;

    // ---- the section: slots from the job's cursor on ---------------------
    const int off = p_off;
    for (int m = p_cur0; m < M; ++m) {
      const int s = off + m;
      // uniform over the block: every thread reads the same shared flags
      const bool can_run = a.tidok[s] > 0 && !s_stopped && !s_broke;
      const bool active = can_run && a.nbe[s] > 0;
      Pick pk{-1, -1, false, false};
      Task t;
      if (active) {
        t = load_task(a.slots, e, s);
        if (aff) aff_eval(ae, N, s, as, aff_red);
        pk = block_pick(e, t, p_tgt != 0, ps, aff ? &ae : nullptr, &as);
      }
      if (tid == 0) {
        const bool do_alloc = active && pk.any_now;
        const bool do_pipe =
            active && !pk.any_now && pk.any_fut && e.pipelining;
        const bool placed = do_alloc || do_pipe;
        int node = -1, mode = MODE_NONE, card = -1;
        if (placed) {
          node = do_alloc ? pk.node_now : pk.node_fut;
          mode = do_alloc ? MODE_ALLOCATED : MODE_PIPELINED;
          card = commit(e, global_view(e), t, node, do_alloc, save,
                        s_nsave++);
        }
        a.node_o[s] = node;
        a.mode_o[s] = mode;
        a.gpu_o[s] = card;
        s_nalloc += do_alloc ? 1 : 0;
        s_npipe += do_pipe ? 1 : 0;
        s_nadv += can_run ? 1 : 0;
        const bool ready_aft = !a.gang || (p_ready0 + s_nalloc) >= p_minav;
        if (placed && ready_aft && a.suffix[s] > 0 && !p_canb) s_stopped = 1;
        if (active && !placed) s_broke = 1;
        as.node = node;
      }
      if (aff && active) {
        __syncthreads();
        if (as.node >= 0) aff_apply(ae, N, s, as.node, 1.0f, as, true);
      }
      __syncthreads();
    }

    // ---- gang finalize and the key-state commit (thread 0) --------------
    const int lo = off + p_cur0, hi = off + M;
    if (tid == 0) {
      s_ready = !a.gang || (p_ready0 + s_nalloc) >= p_minav;
      s_pipelined = (p_ready0 + s_nalloc + s_npipe) >= p_minav && !s_ready;
      s_keep = s_ready || s_pipelined;
    }
    __syncthreads();
    if (aff && !s_keep)
      for (int s = hi - 1; s >= lo; --s)
        if (a.mode_o[s] != MODE_NONE)
          aff_apply(ae, N, s, a.node_o[s], -1.0f, as, false);
    if (tid == 0) {
      const int jstar = p_jstar;
      const bool ready = s_ready, pipelined = s_pipelined, keep = s_keep;
      if (!keep) {
        restore(e, global_view(e), save, s_nsave);
        for (int s = lo; s < hi; ++s) {
          a.node_o[s] = -1;
          a.mode_o[s] = MODE_NONE;
          a.gpu_o[s] = -1;
        }
      } else if (!ready) {
        // kept-but-unready gang: capacity held, no binds
        for (int s = lo; s < hi; ++s)
          if (a.mode_o[s] == MODE_ALLOCATED) a.mode_o[s] = MODE_PIPELINED;
      }
      // committed resources of this pop, added in slot order
      float commit_col[MAX_R];
      for (int r = 0; r < R; ++r) commit_col[r] = 0.0f;
      for (int s = lo; s < hi; ++s)
        if (a.mode_o[s] != MODE_NONE)
          for (int r = 0; r < R; ++r)
            commit_col[r] = commit_col[r] + a.slots.resreq[r * CM + s];
      a.done[jstar] = s_stopped ? 0 : 1;
      a.popped[jstar] = 1;
      a.jready[jstar] = (ready && keep) ? 1 : 0;
      a.jpipe[jstar] = (pipelined && keep) ? 1 : 0;
      a.cursor[jstar] = a.cursor[jstar] + s_nadv;
      if (keep) a.acount[jstar] = a.acount[jstar] + s_nalloc;
      for (int r = 0; r < R; ++r)
        a.jalloc[r * J + jstar] = a.jalloc[r * J + jstar] + commit_col[r];
      const int q = a.qid[jstar];
      if (q >= 0 && q < Q)
        for (int r = 0; r < R; ++r)
          a.qalloc[q * R + r] = a.qalloc[q * R + r] + commit_col[r];
      if (keep && s_nalloc + s_npipe > 0) kept_any = 1;
      if (s_nalloc > 0 || pipelined || ready) prog = 1;
      pops += 1;
    }
    __syncthreads();
  }
  if (tid == 0) {
    a.pops_o[0] = pops;
    a.prog_o[0] = prog;
  }
}

}  // namespace

// ptrs: the inputs in the order of dyn_placer.DynArgs, then the 20
// outputs, then the [2, N] scratch (null where a part is off); dims: see
// Dim, then the key plan; weights: binpack, least, most, balanced, pod
// affinity.
extern "C" int dyn_placer_launch(void* const* ptrs, const int* dims,
                                 const float* weights, void* stream) {
  const int C = dims[D_C], KP = dims[D_KP], M = dims[D_M], N = dims[D_N],
            R = dims[D_R], G = dims[D_G], J = dims[D_J], Q = dims[D_Q],
            S = dims[D_S], nkeys = dims[D_NKEYS], has_aff = dims[D_AFF];
  if (R < 1 || R > MAX_R || C < 1 || M < 1 || N < 1 || G < 0 || J < 1 ||
      J > 32 * BLOCK || Q < 1 || S < 0 || nkeys < 1 || nkeys > MAX_KEYS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto F = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto I = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto FO = [&](int i) { return static_cast<float*>(ptrs[i]); };
  auto IO = [&](int i) { return static_cast<int*>(ptrs[i]); };
  Args a;
  a.slots = SlotEnv{F(P_RESREQ), F(P_GPU_REQ), I(P_PREF), I(P_TMPL),
                    I(P_GRP), I(P_VOLN), I(P_VOLOK), I(P_REV), C * M};
  a.suffix = I(P_SUFFIX);
  a.tidok = I(P_TIDOK);
  a.nbe = I(P_NBE);
  a.cand = I(P_CAND);
  a.cslot = I(P_CSLOT);
  a.skeys = F(P_SKEYS);
  a.hcols = F(P_HCOLS);
  a.qid = I(P_QID);
  a.qoh = F(P_QOH);
  a.nsm = F(P_NSM);
  a.nsc = F(P_NSC);
  a.nsw = F(P_NSW);
  a.minav = I(P_MINAV);
  a.rdy0 = I(P_RDY0);
  a.npend = I(P_NPEND);
  a.eligs = I(P_ELIGS);
  a.validf = F(P_VALIDF);
  a.canb = I(P_CANB);
  a.des = F(P_DES);
  a.qex = F(P_QEX);
  a.total = F(P_TOTAL);
  a.kmax = I(P_KMAX);
  a.tgt = I(P_TGT);
  a.env = NodeEnv{F(P_TSTAT), F(P_TSCORE), F(P_NASCORE), F(P_BLOCKNR),
                  F(P_BLOCKALL), F(P_BONUS), F(P_LOCKED), F(P_ORFEAS),
                  F(P_RELMP), F(P_ALLOC), F(P_CNT), F(P_MAXP), F(P_GIDLE0),
                  FO(O_IDLE), FO(O_PIPE), FO(O_PODS), FO(O_GPUX), N, R, G,
                  dims[D_PIPELINING], weights[0], weights[1], weights[2],
                  weights[3]};
  a.aff = AffEnv{F(P_LIVE), I(P_SKDOM), I(P_SK_SEL), I(P_ETA_SK),
                 I(P_ETA_DOM), F(P_STATIC_PREF), I(P_AFF_SK), I(P_ANTI),
                 I(P_PREFSK), F(P_PREFW), F(P_SKM), F(P_ETM), F(P_SELM),
                 FO(O_AFF_CNT), FO(O_AFF_TOT), FO(O_ANTI_CNT), FO(SCRATCH),
                 FO(SCRATCH) + N, dims[D_SK], dims[D_ETA], dims[D_SEL],
                 dims[D_A], dims[D_B], dims[D_PP], C * M, weights[4]};
  a.idle_in = F(P_IDLE);
  a.pipe_in = F(P_PIPE);
  a.pods_in = F(P_PODS);
  a.gpux_in = F(P_GPUX);
  a.cnt_in = F(P_AFF_CNT);
  a.tot_in = F(P_AFF_TOT);
  a.anti_in = F(P_ANTI_CNT);
  a.done_in = I(P_DONE);
  a.popped_in = I(P_POPPED);
  a.jready_in = I(P_JREADY);
  a.jpipe_in = I(P_JPIPE);
  a.cursor_in = I(P_CURSOR);
  a.acount_in = I(P_ACOUNT);
  a.jalloc_in = F(P_JALLOC);
  a.qalloc_in = F(P_QALLOC);
  a.node_o = IO(O_NODE);
  a.mode_o = IO(O_MODE);
  a.gpu_o = IO(O_GPU);
  a.done = IO(O_DONE);
  a.popped = IO(O_POPPED);
  a.jready = IO(O_JREADY);
  a.jpipe = IO(O_JPIPE);
  a.cursor = IO(O_CURSOR);
  a.acount = IO(O_ACOUNT);
  a.jalloc = FO(O_JALLOC);
  a.qalloc = FO(O_QALLOC);
  a.pops_o = IO(O_POPS);
  a.prog_o = IO(O_PROG);
  a.C = C;
  a.KP = KP;
  a.M = M;
  a.J = J;
  a.Q = Q;
  a.S = S;
  a.NH = dims[D_NH];
  a.gang = dims[D_GANG];
  a.drf_ns = dims[D_DRF_NS];
  a.nkeys = nkeys;
  a.has_aff = has_aff;
  for (int c = 0; c < MAX_KEYS; ++c)
    a.keys[c] = c < nkeys ? dims[N_DIMS + c] : 0;
  int list_ints = 0;
  if (has_aff) {
    const AffEnv& ae = a.aff;
    if (ae.SK < 1 || ae.ETA < 1 || ae.SEL < 1 || ae.A < 1 || ae.B < 1 ||
        ae.PP < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    list_ints = aff_list_ints(ae.SK, ae.ETA, ae.SEL, ae.A, ae.B, ae.PP);
  }
  const size_t smem =
      static_cast<size_t>(M * (2 * R + G + 2) + 2 * Q + S * (R + 1) +
                          list_ints) *
      sizeof(float);
  dyn_placer_kernel<<<1, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
