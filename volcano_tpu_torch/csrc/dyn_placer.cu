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
// What bounds it: not bytes and not arithmetic (a launch moves about a
// megabyte) but a serial chain per pop: the namespace fold, the job
// selection and M dependent attempts, each a reduction with its barriers.
// The earlier design, one block with all state in L2, spent on check B's
// first pop about 170 us of namespace fold (S x R threads, each a chain
// of J adds over two L2 reads), 29 of argmin (one block reduction per key
// column), 12 of eligibility and 7 an attempt on an H100
// (scripts/dyn_phase_split.py; PERF.md).
//
// Design: one thread-block cluster of CB blocks (8 or 16) of CBLOCK
// threads, launched as kernel 1 is (placement.cuh launch_cluster).
// - Block r owns the jobs [r * jcap, min((r + 1) * jcap, J)), jcap =
//   ceil(J / CB), and keeps their rows in its shared memory for the whole
//   launch: the static key rows, hdrf columns, queue one-hot, namespace
//   word, gang and eligibility inputs, and the live done, popped, ready,
//   pipelined, cursor, allocation count and allocation [R]. It also owns
//   the nodes [r * cap, ...), cap = ceil(N / CB), with their live state in
//   shared memory, as kernel 1. The queue allocations [Q, R] are a replica
//   in every block: each applies the same commits in the same order.
// - Per pop, every block computes the queue gate and share from its
//   replica, then (drf namespace order) the namespace fold over the P =
//   S x R (namespace, dim) pairs, in tiles of 32 pairs: for each tile,
//   each block lists its nonzero member terms in job order (a 32-bit mask
//   a job), one cluster barrier, and every block folds the CB lists
//   through distributed shared memory in block order, one warp a pair, so
//   every block holds the sum the plain version folds. A tile after the
//   first takes one more barrier before its listing, since the list buffer
//   of 32 pairs is reused and other blocks may still read the last tile's.
//   Skipping a term of exactly 0 changes no bit: the fold starts at +0.0
//   and x + (+-0) == x for every x but -0.0, which a sum started at +0.0
//   never is. There is no reassociation: each pair's terms are added one
//   at a time in index order.
// - A job's namespace is one int in shared memory (the wrapper derives it
//   from the one-hot rows): the key namespace + 1 in its low 16 bits, the
//   fold namespace + 1 (0 for a job outside every fold) in its high bits.
// - Eligibility and the keys of each of its jobs (the dynamic ones into a
//   table), then its best job: the lexicographic argmin as one reduction
//   of (key columns..., index) tuples with a NaN ordered before every
//   number. The reference's column-by-column filter (each column's min,
//   where a NaN wins, then keep the jobs <= it) picks the same job, or none
//   when the filter meets a NaN, which is exactly when the tuple minimum
//   holds a NaN; the tuple order is total, so the block and cluster
//   reductions are order-free. One cluster exchange (double-buffered by
//   the pop's parity) carries each block's best tuple, its "any eligible",
//   the hdrf guard's queue min and max, and the cursor and allocation
//   count of its proposal (its best, or the first candidate at pop 0), so
//   every block makes the same pop decision.
// - The section's attempts go through cluster_pick (and cluster_aff_eval
//   with pod affinity) as in kernel 1; every block keeps the same section
//   bookkeeping and slot arrays, the owner of the chosen node commits and
//   saves its column, a discard restores each block's own columns and
//   takes back its slice of the affinity rows.
// - Finalize: every block demotes or resets its slot arrays, folds the
//   pop's committed resources in slot order and adds them to its queue
//   replica; the block that owns the popped job updates that job's rows.
// - Each global output has one writer, at the end: each block its slices
//   of the node state, affinity counts and job rows, block 0 the queue
//   allocations, slot nodes and modes, pops and progress, the owner of a
//   slot's node (block 0 where none) its GPU card.
// - A card that cannot place the cluster makes the launch fail: there is
//   no other design to fall back to.
// With a non-null int64 row the launch also writes its phase split
// (clock64() cycles of block 0 by phase, summed over its pops).

#include <cooperative_groups.h>

#include "placement.cuh"

namespace {

using namespace placement;

constexpr int MAX_KEYS = 32;
constexpr int KEY_NS = -1, KEY_QSHARE = -2, KEY_READY = -3, KEY_JSHARE = -4;
constexpr int KEY_HCOL = -8;
// rows of the dynamic key table: codes -1 .. -4
constexpr int N_DYN = 4;
// (namespace, dim) pairs of one tile of the namespace fold, the most
// namespaces a job's namespace word encodes (the namespace sums in shared
// memory bind first), and the most jobs a thread keeps in its eligibility
// bitmask
constexpr int PAIR_TILE = 32;
constexpr int MAX_NS = 0xffff - 1;
constexpr int JOB_BITS = 32;
// static shared memory the kernel may keep: ops/dyn_placer.py's
// MAX_SHARED leaves this much of a block's 232,448 bytes for it
constexpr size_t STATIC_SHARED = 4096;

// pointer slots of dyn_placer_launch: the inputs in the order of
// dyn_placer.DynArgs, then the outputs, then the scratch rows and the
// phase split
enum Ptr {
  P_RESREQ, P_GPU_REQ, P_PREF, P_SUFFIX, P_TMPL, P_GRP, P_VOLN, P_VOLOK,
  P_REV, P_TIDOK, P_NBE, P_CAND, P_CSLOT, P_SKEYS, P_HCOLS, P_QID, P_QOH,
  P_NSID, P_NSC_UNUSED, P_NSW, P_MINAV, P_RDY0, P_NPEND, P_ELIGS, P_VALIDF, P_CANB,
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
  SCRATCH, STAMPS,
  N_PTRS
};

// integer dimensions and flags of dyn_placer_launch; the key plan follows
enum Dim { D_C, D_KP, D_M, D_N, D_R, D_G, D_GR, D_J, D_Q, D_S, D_NH, D_NKS,
           D_GANG, D_PIPELINING, D_DRF_NS, D_NKEYS, D_AFF, D_SK, D_ETA, D_SEL,
           D_A, D_B, D_PP, D_CB, N_DIMS };

// the phase split: clock64() cycles of each phase summed over the launch's
// pops, then the launch's cycles, its globaltimer nanoseconds and its pops
enum Phase { PH_PROLOGUE, PH_GATE_FOLD, PH_ELIG, PH_ARGMIN, PH_ATTEMPTS,
             PH_FINALIZE, N_PHASES };

// Word offsets of one block's dynamic shared memory (ops/dyn_placer.py
// shared_bytes computes the same total): the node part as in kernel 1, the
// launch's slot arrays, the queue replicas and per-pop scratch, then the
// job rows [jcap] each.
struct Plan {
  int cap, jcap, col, P, TP;
  int st, save_node, save_val, slot_node, slot_mode, slot_card, tot, lists;
  int qalloc, des, qex, over, qshare, total, ns_alloc, ns_share, wcnt, woff,
      fcnt;
  int skeys, hcols, qoh, nsid, validf, jalloc, dk, fl;
  int qid, minav, rdy0, npend, eligs, done, popped, jready, jpipe, cursor,
      acount;
  int words;
};

__host__ __device__ inline int take(int& w, int n) {
  const int at = w;
  w += n;
  return at;
}

__host__ __device__ inline Plan make_plan(int N, int J, int CB, int CM,
                                          int M, int R, int G, int Q, int S,
                                          int P, int NKS, int NH, int SK,
                                          int list_ints) {
  Plan p;
  p.cap = (N + CB - 1) / CB;
  p.jcap = (J + CB - 1) / CB;
  p.col = 2 * R + 1 + G;
  p.P = P;
  p.TP = P < PAIR_TILE ? P : PAIR_TILE;
  const int jc = p.jcap;
  int w = 0;
  p.st = take(w, p.col * p.cap);
  p.save_node = take(w, M);
  p.save_val = take(w, M * p.col);
  p.slot_node = take(w, CM);
  p.slot_mode = take(w, CM);
  p.slot_card = take(w, CM);
  p.tot = take(w, SK);
  p.lists = take(w, list_ints);
  p.qalloc = take(w, Q * R);
  p.des = take(w, Q * R);
  p.qex = take(w, Q);
  p.over = take(w, Q);
  p.qshare = take(w, Q);
  p.total = take(w, R);
  p.ns_alloc = take(w, S * R);
  p.ns_share = take(w, S);
  p.wcnt = take(w, p.TP * CWARPS);
  p.woff = take(w, p.TP * CWARPS);
  p.fcnt = take(w, p.TP);
  p.skeys = take(w, NKS * jc);
  p.hcols = take(w, NH * jc);
  p.qoh = take(w, Q * jc);
  p.nsid = take(w, jc);
  p.validf = take(w, jc);
  p.jalloc = take(w, R * jc);
  p.dk = take(w, N_DYN * jc);
  p.fl = take(w, p.TP * jc);
  p.qid = take(w, jc);
  p.minav = take(w, jc);
  p.rdy0 = take(w, jc);
  p.npend = take(w, jc);
  p.eligs = take(w, jc);
  p.done = take(w, jc);
  p.popped = take(w, jc);
  p.jready = take(w, jc);
  p.jpipe = take(w, jc);
  p.cursor = take(w, jc);
  p.acount = take(w, jc);
  p.words = w;
  return p;
}

struct Args {
  NodeEnv env;  // idle, pipe, pods, gpux: the output buffers
  SlotEnv slots;
  AffEnv aff;   // cnt, anti_cnt, tot: the output buffers
  const int* suffix;   // [1, CM]
  const int* tidok;    // [1, CM]
  const int* nbe;      // [1, CM]
  const int* cand;     // [1, C]
  const int* cslot;    // [1, J]
  const float* skeys;  // [NKS, J]
  const float* hcols;  // [NH, J]
  const int* qid;      // [1, J]
  const float* qoh;    // [Q, J]
  const int* nsid;     // [1, J]: the namespace word
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
  long long* stamps;  // [N_PHASES + 3] or null: the phase split
  int C, KP, M, J, Q, S, NH, NKS, gang, drf_ns, nkeys, has_aff, SK,
      list_ints;
  int keys[MAX_KEYS];
};

// One block's partial of a pop's selection exchange.
struct SelSlot {
  int any;         // an eligible job in the block's slice
  int best;        // its best eligible job (global index), J when none
  int cur, acnt;   // cursor and allocation count of its proposal
  float qmn, qmx;  // min and max queue id over its eligible jobs
  float key[MAX_KEYS];  // the best job's key columns
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// -1 when key a orders before key b, 1 after, 0 tied: numbers by value
// (-0.0 ties +0.0), a NaN before every number (it wins the reference's
// column minimum), two NaNs tied
__device__ __forceinline__ int key_cmp(float a, float b) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && nb ? 0 : (na ? -1 : 1);
  return a < b ? -1 : (b < a ? 1 : 0);
}

// The better of two jobs of this block (local indices, -1 none) by their
// key columns, then the lower index.
__device__ __forceinline__ int better_job(const float* const* krow,
                                          int nkeys, int x, int y) {
  if (x < 0) return y;
  if (y < 0) return x;
  for (int c = 0; c < nkeys; ++c) {
    const int d = key_cmp(krow[c][x], krow[c][y]);
    if (d != 0) return d < 0 ? x : y;
  }
  return x < y ? x : y;
}

// The better of two blocks' best jobs (block ranks, -1 none) by the key
// tuples in `tup` [MAX_CB, MAX_KEYS]; tied tuples go to the lower rank,
// whose jobs come first.
__device__ __forceinline__ int better_block(const float* tup, int nkeys,
                                            int x, int y) {
  if (x < 0) return y;
  if (y < 0) return x;
  for (int c = 0; c < nkeys; ++c) {
    const int d = key_cmp(tup[x * MAX_KEYS + c], tup[y * MAX_KEYS + c]);
    if (d != 0) return d < 0 ? x : y;
  }
  return x < y ? x : y;
}

// One block a multiprocessor: the registers of 512 threads may reach 128
// each.
__global__ void __launch_bounds__(CBLOCK, 1)
    dyn_placer_kernel(const __grid_constant__ Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const float EPS_CMP = static_cast<float>(1e-6);
  const float EPS_DIV = static_cast<float>(1e-9);
  const float INF = __int_as_float(0x7f800000);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const NodeEnv& e = a.env;
  const bool aff = a.has_aff != 0;
  const int R = e.R, M = a.M, J = a.J, Q = a.Q, S = a.S, N = e.N;
  const int CM = a.C * M, nkeys = a.nkeys;
  const int CB = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = a.drf_ns ? S * R : 0;
  const Plan pl = make_plan(N, J, CB, CM, M, R, e.G, Q, S, P, a.NKS, a.NH,
                            a.SK, a.list_ints);
  const int cap = pl.cap, jcap = pl.jcap;
  const int lo = min(rank * cap, N), hi = min(lo + cap, N);
  const int jlo = min(rank * jcap, J), jn = min(jlo + jcap, J) - jlo;

  extern __shared__ float smem[];
  auto F = [&](int off) { return smem + off; };
  auto I = [&](int off) { return reinterpret_cast<int*>(smem + off); };
  float* st = F(pl.st);
  const LiveView lv{st, st + R * cap, st + 2 * R * cap,
                    st + (2 * R + 1) * cap, cap, lo};
  const SaveArea save{I(pl.save_node), F(pl.save_val), pl.col};
  int* slot_node = I(pl.slot_node);
  int* slot_mode = I(pl.slot_mode);
  int* slot_card = I(pl.slot_card);
  float* qalloc = F(pl.qalloc);
  float* des = F(pl.des);
  float* qex = F(pl.qex);
  float* over_col = F(pl.over);
  float* qshare = F(pl.qshare);
  float* total = F(pl.total);
  float* ns_alloc = F(pl.ns_alloc);
  float* ns_share = F(pl.ns_share);
  int* wcnt = I(pl.wcnt);
  int* woff = I(pl.woff);
  int* fcnt = I(pl.fcnt);
  float* skeys = F(pl.skeys);
  float* hcols = F(pl.hcols);
  float* qoh = F(pl.qoh);
  int* nsid = I(pl.nsid);
  float* validf = F(pl.validf);
  float* jalloc = F(pl.jalloc);
  float* dk = F(pl.dk);
  float* fl = F(pl.fl);
  int* qid = I(pl.qid);
  int* minav = I(pl.minav);
  int* rdy0 = I(pl.rdy0);
  int* npend = I(pl.npend);
  int* eligs = I(pl.eligs);
  int* done = I(pl.done);
  int* popped = I(pl.popped);
  int* jready = I(pl.jready);
  int* jpipe = I(pl.jpipe);
  int* cursor = I(pl.cursor);
  int* acount = I(pl.acount);
  __shared__ ClusterSlot slots[2];
  __shared__ SelSlot sel[2];
  __shared__ float tup[MAX_CB * MAX_KEYS];
  __shared__ const float* krow[MAX_KEYS];
  __shared__ PickShared ps;
  __shared__ AffShared as;
  __shared__ float aff_red[2 * WARPS];
  __shared__ int w_best[CWARPS], w_any[CWARPS];
  __shared__ float w_qmn[CWARPS], w_qmx[CWARPS];
  __shared__ int p_stop, p_jstar, p_off, p_cur0, p_ready0, p_minav, p_canb,
      p_tgt;
  __shared__ int s_stopped, s_broke, s_nalloc, s_npipe, s_nadv, s_nsave,
      s_keep, s_ready, s_pipelined;
  __shared__ int kept_any, prog, pops;
  static_assert(sizeof(slots) + sizeof(sel) + sizeof(tup) + sizeof(krow) +
                        sizeof(ps) + sizeof(as) + sizeof(aff_red) +
                        sizeof(w_best) + sizeof(w_any) + sizeof(w_qmn) +
                        sizeof(w_qmx) + 20 * sizeof(int) <=
                    STATIC_SHARED,
                "static shared memory over the allowance MAX_SHARED leaves");
  int xc = 0;  // pick and affinity exchanges so far: their slot parity

  const bool stamp_on = a.stamps != nullptr && rank == 0 && tid == 0;
  long long ph[N_PHASES] = {};
  const long long clk0 = stamp_on ? clock64() : 0;
  const unsigned long long ns0 = stamp_on ? global_ns() : 0;
  long long clk_last = clk0;
  auto stamp = [&](int phase) {
    if (stamp_on) {
      const long long now = clock64();
      ph[phase] += now - clk_last;
      clk_last = now;
    }
  };

  // ---- this block's slices of the input state, the queue replicas ------
  AffEnv ae = a.aff;
  ae.tot = F(pl.tot);
  if (aff && tid == 0) aff_bind(as, I(pl.lists), ae);
  load_slice(e, {a.idle_in, a.pipe_in, a.pods_in, a.gpux_in}, st, cap, lo,
             hi);
  if (aff) {
    for (int k = 0; k < ae.SK; ++k)
      for (int i = lo + tid; i < hi; i += CBLOCK)
        ae.cnt[k * N + i] = a.cnt_in[k * N + i];
    for (int k = 0; k < ae.ETA; ++k)
      for (int i = lo + tid; i < hi; i += CBLOCK)
        ae.anti_cnt[k * N + i] = a.anti_in[k * N + i];
    for (int k = tid; k < ae.SK; k += CBLOCK) ae.tot[k] = a.tot_in[k];
  }
  for (int x = tid; x < jn; x += CBLOCK) {
    const int j = jlo + x;
    for (int k = 0; k < a.NKS; ++k) skeys[k * jcap + x] = a.skeys[k * J + j];
    for (int k = 0; k < a.NH; ++k) hcols[k * jcap + x] = a.hcols[k * J + j];
    for (int q = 0; q < Q; ++q) qoh[q * jcap + x] = a.qoh[q * J + j];
    nsid[x] = S > 0 ? a.nsid[j] : 0;
    validf[x] = a.validf[j];
    for (int r = 0; r < R; ++r) jalloc[r * jcap + x] = a.jalloc_in[r * J + j];
    qid[x] = a.qid[j];
    minav[x] = a.minav[j];
    rdy0[x] = a.rdy0[j];
    npend[x] = a.npend[j];
    eligs[x] = a.eligs[j];
    done[x] = a.done_in[j];
    popped[x] = a.popped_in[j];
    jready[x] = a.jready_in[j];
    jpipe[x] = a.jpipe_in[j];
    cursor[x] = a.cursor_in[j];
    acount[x] = a.acount_in[j];
  }
  for (int k = tid; k < Q * R; k += CBLOCK) {
    qalloc[k] = a.qalloc_in[k];
    des[k] = a.des[k];
  }
  for (int q = tid; q < Q; q += CBLOCK) qex[q] = a.qex[q];
  for (int r = tid; r < R; r += CBLOCK) total[r] = a.total[r];
  for (int s = tid; s < CM; s += CBLOCK) {
    slot_node[s] = -1;
    slot_mode[s] = MODE_NONE;
    slot_card[s] = -1;
  }
  if (tid < nkeys) {
    const int code = a.keys[tid];
    krow[tid] = code >= 0 ? skeys + code * jcap
                : code <= KEY_HCOL ? hcols + (KEY_HCOL - code) * jcap
                                   : dk + (-code - 1) * jcap;
  }
  if (tid == 0) {
    kept_any = 0;
    prog = 0;
    pops = 0;
  }
  __syncthreads();
  stamp(PH_PROLOGUE);

  const int kmax = a.kmax[0];
  const int rounds = (jn + CBLOCK - 1) / CBLOCK;
  for (int p = 0; p < a.KP; ++p) {
    // ---- per-queue gate and share, from this block's replica -----------
    if (tid < Q) {
      float over = 0.0f, share = 0.0f;
      for (int r = 0; r < R; ++r) {
        const float qa = qalloc[tid * R + r], d = des[tid * R + r];
        if (qa > d + EPS_CMP) over = 1.0f;
        const float v = (isfinite(d) && d > 0.0f) ? qa / fmaxf(d, EPS_DIV)
                                                  : 0.0f;
        share = r == 0 ? v : fmaxf(share, v);
      }
      over_col[tid] = over;
      qshare[tid] = share + qex[tid];
    }
    // ---- the namespace fold: nonzero member terms in job order, a tile
    // of 32 (namespace, dim) pairs at a time -----------------------------
    for (int t0 = 0; P > 0 && p > 0 && t0 < P; t0 += PAIR_TILE) {
      const int tp = min(PAIR_TILE, P - t0);
      // the last tile's lists may still be read by other blocks
      if (t0 > 0) cluster.sync();
      if (tid < tp) fcnt[tid] = 0;
      __syncthreads();
      for (int k = 0; k < rounds; ++k) {
        const int x = tid + k * CBLOCK;
        // the job's fold namespace, -1 when it is in no fold
        const int fs = x < jn ? (nsid[x] >> 16) - 1 : -1;
        unsigned nz = 0u;
        for (int t = 0; t < tp; ++t) {
          const int s = (t0 + t) / R, r = (t0 + t) % R;
          const float term = fs == s ? jalloc[r * jcap + x] : 0.0f;
          if (term != 0.0f) nz |= 1u << t;
        }
        for (int t = 0; t < tp; ++t) {
          const unsigned b = __ballot_sync(0xffffffffu, (nz >> t) & 1u);
          if (lane == 0) wcnt[t * CWARPS + warp] = __popc(b);
        }
        __syncthreads();
        if (tid < tp) {
          int run = fcnt[tid];
          for (int w = 0; w < CWARPS; ++w) {
            woff[tid * CWARPS + w] = run;
            run += wcnt[tid * CWARPS + w];
          }
          fcnt[tid] = run;
        }
        __syncthreads();
        for (int t = 0; t < tp; ++t) {
          const bool bit = (nz >> t) & 1u;
          const unsigned b = __ballot_sync(0xffffffffu, bit);
          if (bit) {
            const int pos = woff[t * CWARPS + warp] +
                            __popc(b & ((1u << lane) - 1u));
            fl[t * jcap + pos] = jalloc[((t0 + t) % R) * jcap + x];
          }
        }
        __syncthreads();
      }
      cluster.sync();
      // every block folds the CB lists in block order, a warp a pair
      for (int t = warp; t < tp; t += CWARPS) {
        const int n = lane < CB ? cluster.map_shared_rank(fcnt, lane)[t] : 0;
        int incl = n;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += v;
        }
        const int excl = incl - n;
        const int count = __shfl_sync(0xffffffffu, incl, 31);
        float acc = 0.0f;
        for (int base = 0; base < count; base += 4 * 32) {
          float v[4];
          for (int u = 0; u < 4; ++u) {
            const int pos = base + u * 32 + lane;
            int b = 0, b_excl = 0;
            for (int bb = 0; bb < CB; ++bb) {
              const int eb = __shfl_sync(0xffffffffu, excl, bb);
              if (eb <= pos) {
                b = bb;
                b_excl = eb;
              }
            }
            v[u] = pos < count
                       ? cluster.map_shared_rank(fl, b)[t * jcap + pos - b_excl]
                       : 0.0f;
          }
          for (int u = 0; u < 4; ++u) {
            const int left = min(32, count - (base + u * 32));
            for (int k = 0; k < left; ++k)
              acc = acc + __shfl_sync(0xffffffffu, v[u], k);
          }
        }
        if (lane == 0) ns_alloc[t0 + t] = acc;
      }
    }
    if (P > 0 && p > 0) {
      __syncthreads();
      for (int s = tid; s < S; s += CBLOCK) {
        float share = 0.0f;
        for (int r = 0; r < R; ++r) {
          const float t = total[r];
          const float frac =
              t > 0.0f ? ns_alloc[s * R + r] / fmaxf(t, EPS_DIV) : 0.0f;
          share = r == 0 ? frac : fmaxf(share, frac);
        }
        ns_share[s] = share / fmaxf(a.nsw[s], 1.0f);
      }
    }
    __syncthreads();
    stamp(PH_GATE_FOLD);

    // ---- eligibility, and the dynamic keys of the eligible jobs --------
    unsigned bits = 0u;
    float qmn = INF, qmx = -INF;
    for (int u = 0, x = tid; x < jn; x += CBLOCK, ++u) {
      float over = 0.0f;
      for (int q = 0; q < Q; ++q) over = over + qoh[q * jcap + x] * over_col[q];
      if (!(eligs[x] > 0 && done[x] == 0 && cursor[x] < npend[x] &&
            !(over > 0.0f)))
        continue;
      bits |= 1u << u;
      const float qf = static_cast<float>(qid[x]);
      qmn = fminf(qmn, qf);
      qmx = fmaxf(qmx, qf);
      if (p == 0) continue;
      float acc = 0.0f;
      for (int q = 0; q < Q; ++q) acc = acc + qoh[q * jcap + x] * qshare[q];
      dk[(-KEY_QSHARE - 1) * jcap + x] = acc;
      dk[(-KEY_READY - 1) * jcap + x] =
          (rdy0[x] + acount[x] >= minav[x] && minav[x] > 0) ? 1.0f : 0.0f;
      float nk = 0.0f;
      const int ks = (nsid[x] & 0xffff) - 1;
      if (ks >= 0) nk = ns_share[ks];
      dk[(-KEY_NS - 1) * jcap + x] = nk;
      float js = INF;
      if (validf[x] > 0.0f) {
        // the drf dominant share over the live allocation
        for (int r = 0; r < R; ++r) {
          const float t = total[r];
          const float frac =
              t > 0.0f ? jalloc[r * jcap + x] / fmaxf(t, EPS_DIV) : 0.0f;
          js = r == 0 ? frac : fmaxf(js, frac);
        }
      }
      dk[(-KEY_JSHARE - 1) * jcap + x] = js;
    }
    stamp(PH_ELIG);

    // ---- this block's best job, then the selection exchange ------------
    int bx = -1;
    if (p > 0)
      for (int u = 0, x = tid; x < jn; x += CBLOCK, ++u)
        if ((bits >> u) & 1u) bx = better_job(krow, nkeys, bx, x);
    __syncwarp();
    for (int off = 16; off > 0; off >>= 1)
      bx = better_job(krow, nkeys, bx,
                      __shfl_down_sync(0xffffffffu, bx, off));
    const bool w_elig = __any_sync(0xffffffffu, bits != 0u);
    for (int off = 16; off > 0; off >>= 1) {
      qmn = fminf(qmn, __shfl_down_sync(0xffffffffu, qmn, off));
      qmx = fmaxf(qmx, __shfl_down_sync(0xffffffffu, qmx, off));
    }
    if (lane == 0) {
      w_best[warp] = bx;
      w_any[warp] = w_elig;
      w_qmn[warp] = qmn;
      w_qmx[warp] = qmx;
    }
    __syncthreads();
    SelSlot* mine = &sel[p & 1];
    if (warp == 0) {
      bx = lane < CWARPS ? w_best[lane] : -1;
      for (int off = 16; off > 0; off >>= 1)
        bx = better_job(krow, nkeys, bx,
                        __shfl_down_sync(0xffffffffu, bx, off));
      bx = __shfl_sync(0xffffffffu, bx, 0);
      const bool any = __any_sync(0xffffffffu, lane < CWARPS && w_any[lane]);
      float mn = lane < CWARPS ? w_qmn[lane] : INF;
      float mx = lane < CWARPS ? w_qmx[lane] : -INF;
      for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
        mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
      }
      if (bx >= 0)
        for (int c = lane; c < nkeys; c += 32) mine->key[c] = krow[c][bx];
      if (lane == 0) {
        // the proposal: the best job, or the launch's first candidate
        const int c0 = a.cand[0];
        const int px = p > 0 ? bx : (c0 >= jlo && c0 < jlo + jn ? c0 - jlo
                                                                 : -1);
        mine->any = any;
        mine->best = bx >= 0 ? jlo + bx : J;
        mine->qmn = mn;
        mine->qmx = mx;
        mine->cur = px >= 0 ? cursor[px] : 0;
        mine->acnt = px >= 0 ? acount[px] : 0;
      }
    }
    cluster.sync();
    if (warp == 0) {
      const SelSlot* rs =
          cluster.map_shared_rank(mine, lane < CB ? lane : 0);
      const int best = lane < CB ? rs->best : J;
      if (p > 0 && best < J)
        for (int c = 0; c < nkeys; ++c)
          tup[lane * MAX_KEYS + c] = rs->key[c];
      __syncwarp();
      int wb = best < J ? lane : -1;
      for (int off = 16; off > 0; off >>= 1)
        wb = better_block(tup, nkeys, wb,
                          __shfl_down_sync(0xffffffffu, wb, off));
      wb = __shfl_sync(0xffffffffu, wb, 0);
      const bool any = __any_sync(0xffffffffu, lane < CB && rs->any);
      float mn = lane < CB ? rs->qmn : INF, mx = lane < CB ? rs->qmx : -INF;
      for (int off = 16; off > 0; off >>= 1) {
        mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
        mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
      }
      int jsel = J;
      if (p > 0 && any && wb >= 0) {
        jsel = __shfl_sync(0xffffffffu, best, wb);
        // the column filter met a NaN: no job survives it
        for (int c = 0; c < nkeys; ++c)
          if (isnan(tup[wb * MAX_KEYS + c])) jsel = J;
      }
      const int jstar = p == 0 ? a.cand[0] : jsel;
      const bool inside = jstar >= 0 && jstar < J;
      const int owner = inside ? jstar / jcap : 0;
      const int cur = __shfl_sync(0xffffffffu, lane < CB ? rs->cur : 0,
                                  owner);
      const int acnt = __shfl_sync(0xffffffffu, lane < CB ? rs->acnt : 0,
                                   owner);
      if (lane == 0) {
        const bool guard = a.NH > 0 && kept_any && mn != mx;
        const int cs = inside ? a.cslot[jstar] : 0;
        const bool ok = p < kmax && any && !guard && cs >= 0 && inside;
        p_stop = ok ? 0 : 1;
        if (ok) {
          p_jstar = jstar;
          p_off = cs * M;
          p_cur0 = cur;
          p_ready0 = a.rdy0[jstar] + acnt;
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
    }
    __syncthreads();
    stamp(PH_ARGMIN);
    if (p_stop) break;

    // ---- the section: slots from the job's cursor on ---------------------
    const int off = p_off;
    for (int m = p_cur0; m < M; ++m) {
      const int s = off + m;
      // uniform over the cluster: every block keeps the same flags
      const bool can_run = a.tidok[s] > 0 && !s_stopped && !s_broke;
      const bool active = can_run && a.nbe[s] > 0;
      Pick pk{-1, -1, false, false};
      Task t;
      if (active) {
        t = load_task(a.slots, e, s);
        if (aff)
          cluster_aff_eval(cluster, ae, N, s, as, aff_red, lo, hi,
                           &slots[xc++ & 1]);
        pk = cluster_pick(cluster, e, lv, t, p_tgt != 0, ps, lo, hi,
                          &slots[xc++ & 1], aff ? &ae : nullptr, &as);
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
          if (node >= lo && node < hi)
            card = commit(e, lv, t, node, do_alloc, save, s_nsave++);
        }
        slot_node[s] = node;
        slot_mode[s] = mode;
        slot_card[s] = card;
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
        if (as.node >= 0)
          aff_apply(ae, N, s, as.node, 1.0f, as, true, lo, hi, CBLOCK);
      }
      __syncthreads();
    }
    stamp(PH_ATTEMPTS);

    // ---- gang finalize and the key-state commit -------------------------
    const int slo = off + p_cur0, shi = off + M;
    if (tid == 0) {
      s_ready = !a.gang || (p_ready0 + s_nalloc) >= p_minav;
      s_pipelined = (p_ready0 + s_nalloc + s_npipe) >= p_minav && !s_ready;
      s_keep = s_ready || s_pipelined;
    }
    __syncthreads();
    if (!s_keep) {
      if (aff)
        for (int s = shi - 1; s >= slo; --s)
          if (slot_mode[s] != MODE_NONE)
            aff_apply(ae, N, s, slot_node[s], -1.0f, as, false, lo, hi,
                      CBLOCK);
      if (tid == 0) restore(e, lv, save, s_nsave);
    }
    if (tid == 0) {
      const int jstar = p_jstar;
      const bool ready = s_ready, pipelined = s_pipelined, keep = s_keep;
      if (!keep) {
        for (int s = slo; s < shi; ++s) {
          slot_node[s] = -1;
          slot_mode[s] = MODE_NONE;
          slot_card[s] = -1;
        }
      } else if (!ready) {
        // kept-but-unready gang: capacity held, no binds
        for (int s = slo; s < shi; ++s)
          if (slot_mode[s] == MODE_ALLOCATED) slot_mode[s] = MODE_PIPELINED;
      }
      // committed resources of this pop, added in slot order
      float commit_col[MAX_R];
      for (int r = 0; r < R; ++r) commit_col[r] = 0.0f;
      for (int s = slo; s < shi; ++s)
        if (slot_mode[s] != MODE_NONE)
          for (int r = 0; r < R; ++r)
            commit_col[r] = commit_col[r] + a.slots.resreq[r * CM + s];
      if (jstar / jcap == rank) {
        const int x = jstar - jlo;
        done[x] = s_stopped ? 0 : 1;
        popped[x] = 1;
        jready[x] = (ready && keep) ? 1 : 0;
        jpipe[x] = (pipelined && keep) ? 1 : 0;
        cursor[x] = cursor[x] + s_nadv;
        if (keep) acount[x] = acount[x] + s_nalloc;
        for (int r = 0; r < R; ++r)
          jalloc[r * jcap + x] = jalloc[r * jcap + x] + commit_col[r];
      }
      const int q = a.qid[jstar];
      if (q >= 0 && q < Q)
        for (int r = 0; r < R; ++r)
          qalloc[q * R + r] = qalloc[q * R + r] + commit_col[r];
      if (keep && s_nalloc + s_npipe > 0) kept_any = 1;
      if (s_nalloc > 0 || pipelined || ready) prog = 1;
      pops += 1;
    }
    __syncthreads();
    stamp(PH_FINALIZE);
  }

  // ---- this block's slices of the outputs -------------------------------
  store_slice(e, st, cap, lo, hi);
  for (int x = tid; x < jn; x += CBLOCK) {
    const int j = jlo + x;
    a.done[j] = done[x];
    a.popped[j] = popped[x];
    a.jready[j] = jready[x];
    a.jpipe[j] = jpipe[x];
    a.cursor[j] = cursor[x];
    a.acount[j] = acount[x];
    for (int r = 0; r < R; ++r) a.jalloc[r * J + j] = jalloc[r * jcap + x];
  }
  for (int s = tid; s < CM; s += CBLOCK) {
    const int node = slot_node[s];
    if (rank == 0) {
      a.node_o[s] = node;
      a.mode_o[s] = slot_mode[s];
    }
    if (rank == (node >= 0 ? node / cap : 0))
      a.gpu_o[s] = node >= 0 ? slot_card[s] : -1;
  }
  if (rank == 0) {
    for (int k = tid; k < Q * R; k += CBLOCK) a.qalloc[k] = qalloc[k];
    if (aff)
      for (int k = tid; k < ae.SK; k += CBLOCK) a.aff.tot[k] = ae.tot[k];
    if (tid == 0) {
      a.pops_o[0] = pops;
      a.prog_o[0] = prog;
    }
  }
  if (stamp_on) {
    stamp(PH_FINALIZE);
    for (int k = 0; k < N_PHASES; ++k) a.stamps[k] = ph[k];
    a.stamps[N_PHASES] = clock64() - clk0;
    a.stamps[N_PHASES + 1] = static_cast<long long>(global_ns() - ns0);
    a.stamps[N_PHASES + 2] = pops;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

// ptrs: the inputs in the order of dyn_placer.DynArgs, then the 20
// outputs, then the [2, N] scratch and the int64 [N_PHASES + 3] phase
// split (null where a part is off); dims: see Dim, then the key plan;
// weights: binpack, least, most, balanced, pod affinity. Returns 0, a CUDA
// error code, NO_CLUSTER or STATIC_OVER.
extern "C" int dyn_placer_launch(void* const* ptrs, const int* dims,
                                 const float* weights, void* stream) {
  const int C = dims[D_C], KP = dims[D_KP], M = dims[D_M], N = dims[D_N],
            R = dims[D_R], G = dims[D_G], J = dims[D_J], Q = dims[D_Q],
            S = dims[D_S], nkeys = dims[D_NKEYS], has_aff = dims[D_AFF],
            CB = dims[D_CB], drf_ns = dims[D_DRF_NS];
  const int P = drf_ns ? S * R : 0;
  if (R < 1 || R > MAX_R || C < 1 || M < 1 || N < 1 || G < 0 || J < 1 ||
      Q < 1 || S < 0 || nkeys < 1 || nkeys > MAX_KEYS || CB < 1 ||
      CB > MAX_CB || S > MAX_NS || (J + CB - 1) / CB > JOB_BITS * CBLOCK)
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
  a.nsid = I(P_NSID);
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
  a.stamps = static_cast<long long*>(ptrs[STAMPS]);
  a.C = C;
  a.KP = KP;
  a.M = M;
  a.J = J;
  a.Q = Q;
  a.S = S;
  a.NH = dims[D_NH];
  a.NKS = dims[D_NKS];
  a.gang = dims[D_GANG];
  a.drf_ns = drf_ns;
  a.nkeys = nkeys;
  a.has_aff = has_aff;
  for (int c = 0; c < MAX_KEYS; ++c)
    a.keys[c] = c < nkeys ? dims[N_DIMS + c] : 0;
  a.SK = 0;
  a.list_ints = 0;
  if (has_aff) {
    const AffEnv& ae = a.aff;
    if (ae.SK < 1 || ae.ETA < 1 || ae.SEL < 1 || ae.A < 1 || ae.B < 1 ||
        ae.PP < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    a.list_ints = aff_list_ints(ae.SK, ae.ETA, ae.SEL, ae.A, ae.B, ae.PP);
    a.SK = ae.SK;
  }
  const Plan pl = make_plan(N, J, CB, C * M, M, R, G, Q, S, P, a.NKS, a.NH,
                            a.SK, a.list_ints);
  return launch_cluster(dyn_placer_kernel, CB,
                        static_cast<size_t>(pl.words) * 4, STATIC_SHARED,
                        static_cast<cudaStream_t>(stream), a);
}
