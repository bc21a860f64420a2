// Dynamic-key round placer: up to KP job pops over C candidate jobs in one
// launch, the ordering keys recomputed after every gang commit.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_place.py
// `_dyn_kernel` (built by `make_dyn_round_placer`), without the
// pod-affinity extension. The plain PyTorch version of the same function,
// the argument order and the key plan are in
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
//   of placement.cuh (block argmax, thread 0 commits), and thread 0
//   finalizes the gang (keep, or restore the saved columns newest first),
//   demotes kept-but-unready placements, and adds the committed resources,
//   folded in slot order, to the job's and its queue's allocation once per
//   pop (no atomics).
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

struct Args {
  NodeEnv env;
  SlotEnv slots;
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
  int C, KP, M, J, Q, S, NH, gang, drf_ns, nkeys;
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
  const int R = e.R, G = e.G, M = a.M, J = a.J, Q = a.Q, S = a.S;
  const int CM = a.C * M;

  extern __shared__ float smem[];
  const SaveArea save{reinterpret_cast<int*>(smem), smem + M, 2 * R + 1 + G};
  float* over_col = smem + M + M * save.stride;  // [Q]
  float* qshare = over_col + Q;                  // [Q]
  float* ns_alloc = qshare + Q;                  // [S, R]
  float* ns_share = ns_alloc + S * R;            // [S]
  __shared__ PickShared ps;
  __shared__ float red_f[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ float out_f;
  __shared__ int out_i;
  __shared__ int p_stop, p_jstar, p_off, p_cur0, p_ready0, p_minav, p_canb,
      p_tgt;
  __shared__ int s_stopped, s_broke, s_nalloc, s_npipe, s_nadv, s_nsave;
  __shared__ int kept_any, prog, pops;

  // ---- copy the input state to the outputs, updated in place from here
  copy_state(e, a.idle_in, a.pipe_in, a.pods_in, a.gpux_in);
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
        pk = block_pick(e, t, p_tgt != 0, ps);
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
          card = commit(e, t, node, do_alloc, save, s_nsave++);
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
      }
      __syncthreads();
    }

    // ---- gang finalize and the key-state commit (thread 0) --------------
    if (tid == 0) {
      const int jstar = p_jstar;
      const bool ready = !a.gang || (p_ready0 + s_nalloc) >= p_minav;
      const bool pipelined =
          (p_ready0 + s_nalloc + s_npipe) >= p_minav && !ready;
      const bool keep = ready || pipelined;
      const int lo = off + p_cur0, hi = off + M;
      if (!keep) {
        restore(e, save, s_nsave);
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

// ptrs: the 56 inputs then the 17 outputs in the order of
// dyn_placer.DynArgs (null where a part is off); dims: C, KP, M, N, R, G,
// GR, J, Q, S, NH, NKS, gang, pipelining, drf_ns, nkeys, then the key
// plan; weights: binpack, least, most, balanced.
extern "C" int dyn_placer_launch(void* const* ptrs, const int* dims,
                                 const float* weights, void* stream) {
  const int C = dims[0], KP = dims[1], M = dims[2], N = dims[3], R = dims[4],
            G = dims[5], J = dims[7], Q = dims[8], S = dims[9],
            nkeys = dims[15];
  if (R < 1 || R > MAX_R || C < 1 || M < 1 || N < 1 || G < 0 || J < 1 ||
      J > 32 * BLOCK || Q < 1 || S < 0 || nkeys < 1 || nkeys > MAX_KEYS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto F = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto I = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto FO = [&](int i) { return static_cast<float*>(ptrs[i]); };
  auto IO = [&](int i) { return static_cast<int*>(ptrs[i]); };
  Args a;
  // inputs, in DynArgs order
  a.slots = SlotEnv{F(0), F(1), I(2), I(4), I(5), I(6), I(7), I(8), C * M};
  a.suffix = I(3);
  a.tidok = I(9);
  a.nbe = I(10);
  a.cand = I(11);
  a.cslot = I(12);
  a.skeys = F(13);
  a.hcols = F(14);
  a.qid = I(15);
  a.qoh = F(16);
  a.nsm = F(17);
  a.nsc = F(18);
  a.nsw = F(19);
  a.minav = I(20);
  a.rdy0 = I(21);
  a.npend = I(22);
  a.eligs = I(23);
  a.validf = F(24);
  a.canb = I(25);
  a.des = F(26);
  a.qex = F(27);
  a.total = F(28);
  a.kmax = I(29);
  a.tgt = I(30);
  // outputs follow the 56 inputs
  a.env = NodeEnv{F(31), F(32), F(33), F(34), F(35),  F(36),
                  F(37), F(38), F(39), F(40), F(41),  F(42),
                  F(43), FO(59), FO(60), FO(61), FO(62), N,
                  R,     G,     dims[13], weights[0], weights[1], weights[2],
                  weights[3]};
  a.idle_in = F(44);
  a.pipe_in = F(45);
  a.pods_in = F(46);
  a.gpux_in = F(47);
  a.done_in = I(48);
  a.popped_in = I(49);
  a.jready_in = I(50);
  a.jpipe_in = I(51);
  a.cursor_in = I(52);
  a.acount_in = I(53);
  a.jalloc_in = F(54);
  a.qalloc_in = F(55);
  a.node_o = IO(56);
  a.mode_o = IO(57);
  a.gpu_o = IO(58);
  a.done = IO(63);
  a.popped = IO(64);
  a.jready = IO(65);
  a.jpipe = IO(66);
  a.cursor = IO(67);
  a.acount = IO(68);
  a.jalloc = FO(69);
  a.qalloc = FO(70);
  a.pops_o = IO(71);
  a.prog_o = IO(72);
  a.C = C;
  a.KP = KP;
  a.M = M;
  a.J = J;
  a.Q = Q;
  a.S = S;
  a.NH = dims[10];
  a.gang = dims[12];
  a.drf_ns = dims[14];
  a.nkeys = nkeys;
  for (int c = 0; c < MAX_KEYS; ++c) a.keys[c] = c < nkeys ? dims[16 + c] : 0;
  const size_t smem =
      static_cast<size_t>(M * (2 * R + G + 2) + 2 * Q + S * (R + 1)) *
      sizeof(float);
  dyn_placer_kernel<<<1, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
