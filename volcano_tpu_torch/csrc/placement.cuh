// The placement step shared by the round placers: one task slot placed on
// the node axis by one thread-block cluster.
//
// Port of volcano_tpu/ops/pallas_place.py `_make_attempt` (feasibility ->
// score -> lowest-index argmax -> commit) and `_dyn_score`, used by
// round_placer.cu (`_batch_kernel`) and dyn_placer.cu (`_dyn_kernel`), and
// of its pod-affinity extension (`_read_aff_env`, `_aff_eval`,
// `_aff_commit`, pallas_place.py:186-331). At the end, the row evaluation
// of the shard-local kernels (`shard_row`), which shard_candidates.cu
// (`_shard_cand_kernel`) and shard_wave.cu (`_shard_wave_kernel`) share,
// and their candidate merge.
//
// - A node's row (node_eval): feasibility on idle ("now") and on future
//   idle, and the score, read from the static maps in global memory and
//   from the live state through a LiveView: one cluster block's slice of
//   the [R, N] state in shared memory (kernels 1 and 3), or the whole state
//   in global memory (the shard-local kernels' rows).
// - cluster_pick (kernels 1 and 3): each block of a cluster of CB blocks
//   evaluates its own contiguous slice of the nodes and reduces it to one
//   (score, lowest index) per view, the reference's tie-break, and the
//   views' "any feasible" flags; after one cluster barrier every block
//   reads the CB
//   partials through distributed shared memory and merges them. Max with
//   the lowest index and OR are exact and order-free, so every block
//   reaches the same pick, the one-block pick. The partials are
//   double-buffered by the parity of the launch's exchange count, so one
//   barrier an exchange is enough: a block can only overwrite a buffer
//   after the next barrier, which every block passes only once it has read
//   that buffer.
// - commit (thread 0 of the block that owns the node): saves the chosen
//   node's column, then takes the task's request from it and picks the
//   lowest fitting GPU card.
// - restore (thread 0): puts saved columns back, newest first, when a
//   gang is discarded. Subtracting back would not do: (a - r) + r != a in
//   float32. Columns of different nodes are independent, so each cluster
//   block restores the columns it saved and the result is that of one
//   block restoring them all.
// - Pod affinity (AffEnv, when the cycle compiles it in): the live counts
//   cnt [SK, N] and anti [ETA, N] are global memory (each cluster block
//   reads and writes only its slice), tot [SK, 1] a replica in each cluster
//   block's shared memory (every block applies the same integer-valued
//   deltas to it). Each attempt first runs the affinity pass: thread 0
//   lists the task's terms in shared memory (its required pairs, own anti
//   terms, preferred pairs, and only the ETA / SEL rows the task matches:
//   the rows it does not match add `false` or 0 * x, and every sum is
//   integer-valued, so skipping them changes no bit), then one pass
//   computes each node's affinity mask and raw preferred score into a
//   scratch row and reduces the raw score's max and min over the live
//   nodes (a second exchange). The pick, the second pass, ANDs the mask
//   into both views and adds weight * the min-max normalised score last.
//   aff_apply adds (or, on a gang discard, takes back) one placement's
//   domain-membership rows over a span of nodes. The discard takes back
//   instead of copying back: the counts are integer-valued float32 far
//   below 2^24, so (c + 1) - 1 == c exactly, and an undo costs what its
//   commit cost, where a copy-back would save SK x N + ETA x N floats
//   every section.
//
// Bit-exactness with the reference: build with --fmad=false and without
// fast math, so no multiply-add is contracted and division and sqrt are
// IEEE; every sum over R folds in index order from 0; every constant is
// rounded from the double the reference writes, as JAX rounds it.
//
// Resource dims: R has no bound here. Each kernel is built twice, for
// R <= REG_R (WIDE = false: a task's request and a node's allocatable and
// used columns in registers, one slot a dim) and for R > REG_R (WIDE =
// true: each dim read where it is used, from device or shared memory, so
// the registers do not grow with R); the launchers pick by R. Both fold
// the same operations in the same order, so they give the same bits; the
// balanced score's second pass recomputes each dim's fraction from the
// same operands instead of keeping it. Only a kernel's shared-memory plan
// bounds R (its node slice and saved columns are 2R + 1 + G words a node).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

namespace placement {

namespace cg = cooperative_groups;

// the most warps a block has (sizes the reduction scratch)
constexpr int WARPS = 32;
// threads of each block of the cluster kernels, and the largest cluster
constexpr int CBLOCK = 512;
constexpr int CWARPS = CBLOCK / 32;
constexpr int MAX_CB = 16;
// resource dims the narrow instantiations keep in registers
constexpr int REG_R = 8;
constexpr int MODE_NONE = 0;
constexpr int MODE_ALLOCATED = 1;
constexpr int MODE_PIPELINED = 2;

// static node maps and the live node state
struct NodeEnv {
  const float* tstat;    // [P, N]
  const float* tscore;   // [P, N]
  const float* nascore;  // [P, N]
  const float* blocknr;  // [1, N]
  const float* blockall;
  const float* bonus;
  const float* locked;
  const float* orfeas;   // [GR, N]
  const float* relmp;    // [R, N]
  const float* alloc;    // [R, N]
  const float* cnt;      // [1, N]
  const float* maxp;     // [1, N]
  const float* gidle0;   // [G, N]
  float* idle;           // [R, N] live
  float* pipe;           // [R, N] live
  float* pods;           // [1, N] live
  float* gpux;           // [G, N] live
  int N, R, G, pipelining;
  float w_bin, w_least, w_most, w_bal;
};

// Where the live state of node i lies: row r of idle at idle[k(r, i)], and
// so pipe, pods (row 0) and gpux. The whole [R, N] state in global memory
// (ld = N, base = 0), or the slice [base, base + ld) of it in shared memory.
struct LiveView {
  float* idle;
  float* pipe;
  float* pods;
  float* gpux;
  int ld, base;
  __device__ __forceinline__ int k(int r, int i) const {
    return r * ld + (i - base);
  }
};

__device__ __forceinline__ LiveView global_view(const NodeEnv& e) {
  return {e.idle, e.pipe, e.pods, e.gpux, e.N, 0};
}

// per-slot rows of one launch, [.., S] with S slots
struct SlotEnv {
  const float* resreq;   // [R, S]
  const float* gpu_req;  // [1, S] (GPU path only)
  const int* pref;
  const int* tmpl;
  const int* grp;
  const int* voln;
  const int* volok;
  const int* rev;
  int S;
};

// A task's request over the R dims: in registers (narrow) ...
template <bool WIDE>
struct ReqRow {
  float v[REG_R];
  __device__ __forceinline__ void load(const float* p, int stride, int R) {
    for (int r = 0; r < R; ++r) v[r] = p[r * stride];
  }
  __device__ __forceinline__ float operator[](int r) const { return v[r]; }
};

// ... or read in place, dim r at p[r * stride] (WIDE)
template <>
struct ReqRow<true> {
  const float* p;
  int stride;
  __device__ __forceinline__ void load(const float* q, int s, int) {
    p = q;
    stride = s;
  }
  __device__ __forceinline__ float operator[](int r) const {
    return p[r * stride];
  }
};

// one slot's scalars, read by every thread
template <bool WIDE>
struct Task {
  ReqRow<WIDE> rr;
  float gr;
  int tmpl, grp, voln, pref;
  bool volok, rev;
};

template <bool WIDE>
__device__ __forceinline__ Task<WIDE> load_task(const SlotEnv& se,
                                                const NodeEnv& e, int s) {
  Task<WIDE> t;
  t.rr.load(se.resreq + s, se.S, e.R);
  t.gr = e.G > 0 ? se.gpu_req[s] : 0.0f;
  t.tmpl = se.tmpl[s];
  t.grp = se.grp[s];
  t.voln = se.voln[s];
  t.pref = se.pref[s];
  t.volok = se.volok[s] > 0;
  t.rev = se.rev[s] > 0;
  return t;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// Node i's allocatable and used (allocatable - idle) of each dim: in
// registers (narrow) ...
template <bool WIDE>
struct NodeCols {
  float a[REG_R], u[REG_R];
  __device__ __forceinline__ NodeCols(const NodeEnv& e, const LiveView& lv,
                                      int i) {
    for (int r = 0; r < e.R; ++r) {
      a[r] = e.alloc[r * e.N + i];
      u[r] = a[r] - lv.idle[lv.k(r, i)];
    }
  }
  __device__ __forceinline__ float alloc(int r) const { return a[r]; }
  __device__ __forceinline__ float used(int r) const { return u[r]; }
};

// ... or computed where used, by the same operations (WIDE)
template <>
struct NodeCols<true> {
  const NodeEnv& e;
  const LiveView& lv;
  int i;
  __device__ __forceinline__ NodeCols(const NodeEnv& e_, const LiveView& lv_,
                                      int i_)
      : e(e_), lv(lv_), i(i_) {}
  __device__ __forceinline__ float alloc(int r) const {
    return e.alloc[r * e.N + i];
  }
  __device__ __forceinline__ float used(int r) const {
    return alloc(r) - lv.idle[lv.k(r, i)];
  }
};

// pallas_place._dyn_score for node i, in the reference's operation order
template <bool WIDE>
__device__ float dyn_score(const NodeEnv& e, const LiveView& lv, int i,
                          const ReqRow<WIDE>& rr) {
  const float EPS_DIV = static_cast<float>(1e-9);
  const float OVER = static_cast<float>(1.0 + 1e-6);
  const int R = e.R;
  const NodeCols<WIDE> nc(e, lv, i);
  float score = 0.0f;
  if (e.w_bin != 0.0f) {
    float wsum = 0.0f, fsum = 0.0f;
    bool over = false;
    for (int r = 0; r < R; ++r) {
      const bool app = rr[r] > 0.0f && nc.alloc(r) > 0.0f;
      const float frac =
          app ? (nc.used(r) + rr[r]) / fmaxf(nc.alloc(r), EPS_DIV) : 0.0f;
      over = over || frac > OVER;
      const float w = app ? 1.0f : 0.0f;
      wsum = wsum + w;
      fsum = fsum + frac * w;
    }
    float raw = fsum / fmaxf(wsum, EPS_DIV);
    if (over) raw = 0.0f;
    score = score + (e.w_bin * raw) * 100.0f;
  }
  if (e.w_least != 0.0f) {
    int n = 0;
    float s = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float cap = fmaxf(nc.alloc(r), EPS_DIV);
      const float free_frac = ((nc.alloc(r) - nc.used(r)) - rr[r]) / cap;
      const bool counted = nc.alloc(r) > 0.0f;
      n += counted ? 1 : 0;
      s = s + clip01(free_frac) * (counted ? 1.0f : 0.0f);
    }
    n = n > 1 ? n : 1;
    score = score + e.w_least * ((s / static_cast<float>(n)) * 100.0f);
  }
  if (e.w_most != 0.0f) {
    int n = 0;
    float s = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float cap = fmaxf(nc.alloc(r), EPS_DIV);
      const float used_frac = (nc.used(r) + rr[r]) / cap;
      const bool counted = nc.alloc(r) > 0.0f;
      n += counted ? 1 : 0;
      s = s + clip01(used_frac) * (counted ? 1.0f : 0.0f);
    }
    n = n > 1 ? n : 1;
    score = score + e.w_most * ((s / static_cast<float>(n)) * 100.0f);
  }
  if (e.w_bal != 0.0f) {
    // two passes in index order: the mean, then the variance about it;
    // the narrow build keeps each dim's fraction, the wide one recomputes it
    auto frac_of = [&](int r) {
      return clip01((nc.used(r) + rr[r]) / fmaxf(nc.alloc(r), EPS_DIV));
    };
    auto counted_of = [&](int r) { return nc.alloc(r) > 0.0f ? 1.0f : 0.0f; };
    float frac[WIDE ? 1 : REG_R], counted[WIDE ? 1 : REG_R];
    float nsum = 0.0f, fsum = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float f = frac_of(r), c = counted_of(r);
      if constexpr (!WIDE) {
        frac[r] = f;
        counted[r] = c;
      }
      nsum = nsum + c;
      fsum = fsum + f * c;
    }
    const float n = fmaxf(nsum, 1.0f);
    const float mean = fsum / n;
    float vsum = 0.0f;
    for (int r = 0; r < R; ++r) {
      float f, c;
      if constexpr (WIDE) {
        f = frac_of(r);
        c = counted_of(r);
      } else {
        f = frac[r];
        c = counted[r];
      }
      const float d = f - mean;
      vsum = vsum + (d * d) * c;
    }
    const float var = vsum / n;
    score = score + (e.w_bal * (1.0f - sqrtf(var))) * 100.0f;
  }
  return score;
}

// (score, index) order of the argmax: higher score, then lower index
__device__ __forceinline__ void take_better(float& bs, int& bi, float s,
                                            int i) {
  if (s > bs || (s == bs && i < bi)) {
    bs = s;
    bi = i;
  }
}

// ---------------------------------------------------------------------------
// pod affinity (kernel 2 of the reference: pallas_place.py:186-331)
// ---------------------------------------------------------------------------

// static affinity maps, the slot tables of one launch, the live counts
struct AffEnv {
  const float* live;         // [1, N] valid & schedulable nodes
  const int* skdom;          // [SK, N] node's domain per (sel, key) pair
  const int* sk_sel;         // [SK, 1]
  const int* eta_sk;         // [1, ETA]
  const int* eta_dom;        // [ETA, N]
  const float* static_pref;  // [SEL, N] symmetric preferred map
  const int* aff_sk;         // [A, S] required-affinity pair slots
  const int* anti;           // [B, S] own required-anti term slots
  const int* prefsk;         // [PP, S] preferred pair slots
  const float* prefw;        // [PP, S] preferred weights
  const float* skm;          // [SK, S] task matches the pair's selector
  const float* etm;          // [ETA, S] task matches the anti term
  const float* selm;         // [SEL, S] task matches the selector
  float* cnt;                // [SK, N] live
  float* tot;                // [SK, 1] live
  float* anti_cnt;           // [ETA, N] live
  float* raw;                // [N] scratch: raw preferred score
  float* ok;                 // [N] scratch: affinity mask (1 / 0)
  int SK, ETA, SEL, A, B, PP, S;
  float weight;              // pod_affinity_weight
};

// ints of dynamic shared memory the per-attempt term lists take (host side:
// the launchers size the dynamic shared memory with it)
inline int aff_list_ints(int SK, int ETA, int SEL, int A, int B, int PP) {
  return 2 * A + 2 * B + ETA + 2 * PP + 2 * SEL + SK;
}

// one attempt's term lists (dynamic shared memory) and its scalars
struct AffShared {
  int* req;      // [A] required pairs
  int* esc;      // [A] first-pod escape open (tot == 0 and task matches)
  int* own_e;    // [B] own anti terms
  int* own_sk;   // [B] their pair row max(eta_sk, 0)
  int* sym;      // [ETA] anti terms the task matches
  int* pp_sk;    // [PP] preferred pair, -1 when the slot is empty
  float* pp_w;   // [PP]
  int* sel;      // [SEL] selectors the task matches
  float* sel_w;  // [SEL] their match value
  int* mine;     // [SK] pairs whose counts a placement of the task adds to
  int nreq, nown, nsym, nsel, nmine;
  float mn, q;   // normalisation: (raw - mn) * q when span > 0
  int span_pos;
  int node;      // the attempt's placement, -1 none
};

__device__ inline void aff_bind(AffShared& as, int* base, const AffEnv& ae) {
  as.req = base;
  as.esc = as.req + ae.A;
  as.own_e = as.esc + ae.A;
  as.own_sk = as.own_e + ae.B;
  as.sym = as.own_sk + ae.B;
  as.pp_sk = as.sym + ae.ETA;
  as.pp_w = reinterpret_cast<float*>(as.pp_sk + ae.PP);
  as.sel = reinterpret_cast<int*>(as.pp_w + ae.PP);
  as.sel_w = reinterpret_cast<float*>(as.sel + ae.SEL);
  as.mine = reinterpret_cast<int*>(as.sel_w + ae.SEL);
}

// Thread 0 only: the term lists of slot s against the live totals.
__device__ void aff_lists(const AffEnv& ae, int s, AffShared& as) {
  const int S = ae.S;
  as.nreq = 0;
  for (int a = 0; a < ae.A; ++a) {
    const int sk = ae.aff_sk[a * S + s];
    if (sk < 0) continue;
    as.req[as.nreq] = sk;
    as.esc[as.nreq] = ae.tot[sk] == 0.0f && ae.skm[sk * S + s] > 0.0f;
    ++as.nreq;
  }
  as.nown = 0;
  for (int b = 0; b < ae.B; ++b) {
    const int e = ae.anti[b * S + s];
    if (e < 0) continue;
    as.own_e[as.nown] = e;
    as.own_sk[as.nown] = ae.eta_sk[e] > 0 ? ae.eta_sk[e] : 0;
    ++as.nown;
  }
  as.nsym = 0;
  for (int e = 0; e < ae.ETA; ++e)
    if (ae.etm[e * S + s] > 0.0f) as.sym[as.nsym++] = e;
  for (int p = 0; p < ae.PP; ++p) {
    as.pp_sk[p] = ae.prefsk[p * S + s];
    as.pp_w[p] = ae.prefw[p * S + s];
  }
  as.nsel = 0;
  for (int c = 0; c < ae.SEL; ++c) {
    const float m = ae.selm[c * S + s];
    if (m != 0.0f) {
      as.sel[as.nsel] = c;
      as.sel_w[as.nsel] = m;
      ++as.nsel;
    }
  }
  as.nmine = 0;
  for (int k = 0; k < ae.SK; ++k)
    if (ae.sk_sel[k] >= 0 && ae.skm[k * S + s] > 0.0f) as.mine[as.nmine++] = k;
}

// Node i's affinity mask (returned) and raw preferred score (`raw`) for the
// task whose term lists `as` holds, against the live counts.
__device__ __forceinline__ bool aff_node(const AffEnv& ae, const AffShared& as,
                                         int N, int i, float& raw) {
  bool ok = true;
  for (int k = 0; k < as.nreq; ++k) {
    const int sk = as.req[k];
    const bool dom = ae.skdom[sk * N + i] >= 0;
    ok = ok && dom && (ae.cnt[sk * N + i] > 0.0f || as.esc[k]);
  }
  for (int k = 0; k < as.nown; ++k)
    ok = ok && !(ae.cnt[as.own_sk[k] * N + i] > 0.0f &&
                 ae.eta_dom[as.own_e[k] * N + i] >= 0);
  for (int k = 0; k < as.nsym; ++k) {
    const int e = as.sym[k];
    ok = ok && !(ae.anti_cnt[e * N + i] > 0.0f && ae.eta_dom[e * N + i] >= 0);
  }
  raw = 0.0f;
  for (int p = 0; p < ae.PP; ++p) {
    const int sk = as.pp_sk[p] > 0 ? as.pp_sk[p] : 0;
    const float row = (as.pp_sk[p] >= 0 && ae.skdom[sk * N + i] >= 0)
                          ? as.pp_w[p] * ae.cnt[sk * N + i]
                          : 0.0f;
    raw = p == 0 ? row : raw + row;
  }
  float st = 0.0f;
  for (int k = 0; k < as.nsel; ++k)
    st = st + as.sel_w[k] * ae.static_pref[as.sel[k] * N + i];
  raw = raw + st;
  return ok;
}

// Thread 0 only: the normalisation from the raw score's max and min over
// the live nodes.
__device__ __forceinline__ void aff_norm(AffShared& as, float mx, float mn) {
  const float EPS_DIV = static_cast<float>(1e-9);
  const float span = mx - mn;
  as.mn = mn;
  as.q = 100.0f / fmaxf(span, EPS_DIV);
  as.span_pos = span > 0.0f;
}

// Called by every thread: the first pass of an attempt over nodes lo + t,
// lo + t + step, ... below hi. Writes each node's affinity mask and raw
// preferred score to the scratch rows and reduces the raw score's max and
// min over the live ones, through `red` [2 * WARPS], to warp 0's lane 0.
__device__ void aff_pass(const AffEnv& ae, int N, const AffShared& as,
                         float* red, int lo, int hi, int step, float& mx,
                         float& mn) {
  const float BIG = static_cast<float>(3.4e38);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = step / 32;
  mx = -BIG;
  mn = BIG;
  for (int i = lo + tid; i < hi; i += step) {
    float raw;
    const bool ok = aff_node(ae, as, N, i, raw);
    ae.raw[i] = raw;
    ae.ok[i] = ok ? 1.0f : 0.0f;
    if (ae.live[i] > 0.0f) {
      mx = fmaxf(mx, raw);
      mn = fminf(mn, raw);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
    mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
  }
  if (lane == 0) {
    red[warp] = mx;
    red[WARPS + warp] = mn;
  }
  __syncthreads();
  if (warp == 0) {
    mx = lane < nwarps ? red[lane] : -BIG;
    mn = lane < nwarps ? red[WARPS + lane] : BIG;
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
    }
  }
}

// Called by every thread: add `delta` (1 on a placement, -1 to take it back
// on a gang discard) to the domain-membership rows of slot s's task placed
// on `node` (pallas_place._aff_commit). Adds to members only: the
// reference's + 0.0 elsewhere changes no count (counts are never -0.0).
// `listed`: the term lists in `as` are slot s's already (a commit right
// after the slot's cluster_aff_eval).
// The rows change over nodes lo + t, lo + t + step, ... below hi (a
// cluster block's slice); `ae.tot` (the block's replica) changes by
// `delta` too.
__device__ void aff_apply(const AffEnv& ae, int N, int s, int node,
                          float delta, AffShared& as, bool listed, int lo,
                          int hi, int step) {
  if (!listed) {
    if (threadIdx.x == 0) aff_lists(ae, s, as);
    __syncthreads();
  }
  for (int k = 0; k < as.nmine; ++k) {
    const int sk = as.mine[k];
    const int* dom = ae.skdom + sk * N;
    const int d = dom[node];
    if (d < 0) continue;
    float* row = ae.cnt + sk * N;
    for (int i = lo + threadIdx.x; i < hi; i += step)
      if (dom[i] == d) row[i] = row[i] + delta;
    if (threadIdx.x == 0) ae.tot[sk] = ae.tot[sk] + delta;
  }
  for (int k = 0; k < as.nown; ++k) {
    const int e = as.own_e[k];
    const int* dom = ae.eta_dom + e * N;
    const int d = dom[node];
    if (d < 0) continue;
    float* row = ae.anti_cnt + e * N;
    for (int i = lo + threadIdx.x; i < hi; i += step)
      if (dom[i] == d) row[i] = row[i] + delta;
  }
  __syncthreads();
}

struct PickShared {
  float red_s[2][WARPS];
  int red_i[2][WARPS];
  int pick_i[2];
};

struct Pick {
  int node_now, node_fut;
  bool any_now, any_fut;
};

struct NodeEval {
  bool now, fut;  // feasible on idle / on future idle
  float score;    // NEG when neither
};

// Node i for task t: the row code of both picks, in the reference's order.
// With `ae` (pod affinity on), after the affinity pass: its mask joins
// both views and weight * the normalised preferred score joins the score,
// last.
template <bool WIDE>
__device__ __forceinline__ NodeEval node_eval(const NodeEnv& e,
                                              const LiveView& lv,
                                              const Task<WIDE>& t, bool is_tgt,
                                              int i, const AffEnv* ae,
                                              const AffShared* as) {
  const float EPS_FIT = static_cast<float>(1e-5);
  const float NEG = static_cast<float>(-1e30);
  const int N = e.N, R = e.R, G = e.G;
  const float grm = t.gr - EPS_FIT;
  bool sf = e.tstat[t.tmpl * N + i] > 0.0f;
  sf = sf && !(e.blocknr[i] > 0.0f && !t.rev) && !(e.blockall[i] > 0.0f);
  if (t.grp >= 0) sf = sf && e.orfeas[t.grp * N + i] > 0.0f;
  sf = sf && t.volok && (t.voln < 0 || i == t.voln);
  sf = sf && (!(e.locked[i] > 0.0f) || is_tgt);
  bool shared = sf && (e.cnt[i] + lv.pods[lv.k(0, i)]) < e.maxp[i];
  if (G > 0 && !(t.gr <= 0.0f)) {
    bool any = false;
    for (int g = 0; g < G; ++g)
      any = any || (e.gidle0[g * N + i] - lv.gpux[lv.k(g, i)]) >= grm;
    shared = shared && any;
  }
  bool fit_now = true, fit_fut = true;
  for (int r = 0; r < R; ++r) {
    const float idle_r = lv.idle[lv.k(r, i)];
    const float fut_r =
        fmaxf((idle_r + e.relmp[r * N + i]) - lv.pipe[lv.k(r, i)], 0.0f);
    fit_now = fit_now && t.rr[r] <= idle_r + EPS_FIT;
    fit_fut = fit_fut && t.rr[r] <= fut_r + EPS_FIT;
  }
  if (ae != nullptr) shared = shared && ae->ok[i] > 0.0f;
  NodeEval ne{shared && fit_now, shared && fit_fut, NEG};
  if (ne.now || ne.fut) {
    float sc = dyn_score<WIDE>(e, lv, i, t.rr);
    sc = sc + e.tscore[t.tmpl * N + i];
    sc = sc + (e.nascore[t.tmpl * N + i] + (t.rev ? e.bonus[i] : 0.0f));
    sc = sc + ((t.pref >= 0 && i == t.pref) ? 100.0f : 0.0f);
    if (ae != nullptr) {
      const float norm = as->span_pos ? (ae->raw[i] - as->mn) * as->q : 0.0f;
      sc = sc + ae->weight * norm;
    }
    ne.score = sc;
  }
  return ne;
}

// Every thread's running best of nodes lo + t, lo + t + step, ... below
// hi, reduced over each warp to its lane 0: per view the highest masked
// score, the lowest index at it, and whether any node is feasible.
template <bool WIDE>
__device__ __forceinline__ void pick_rows(const NodeEnv& e, const LiveView& lv,
                                          const Task<WIDE>& t, bool is_tgt, int lo,
                                          int hi, int step, const AffEnv* ae,
                                          const AffShared* as, float* best,
                                          int* bidx, bool* found) {
  const float NEG = static_cast<float>(-1e30);
  const float lowest = __int_as_float(0xff800000);  // -inf
  for (int v = 0; v < 2; ++v) {
    best[v] = lowest;
    bidx[v] = e.N;
    found[v] = false;
  }
  for (int i = lo + threadIdx.x; i < hi; i += step) {
    const NodeEval ne = node_eval(e, lv, t, is_tgt, i, ae, as);
    const bool feas[2] = {ne.now, ne.fut};
    for (int v = 0; v < 2; ++v) {
      take_better(best[v], bidx[v], feas[v] ? ne.score : NEG, i);
      found[v] = found[v] || feas[v];
    }
  }
  for (int v = 0; v < 2; ++v)
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best[v], off);
      const int oi = __shfl_down_sync(0xffffffffu, bidx[v], off);
      take_better(best[v], bidx[v], os, oi);
    }
}

// The warps' partials of view `warp` (warps 0 and 1), reduced to lane 0.
__device__ __forceinline__ void pick_warps(const PickShared& ps, int nwarps,
                                           int n, float& bs, int& bi) {
  const int lane = threadIdx.x & 31, v = threadIdx.x >> 5;
  bs = lane < nwarps ? ps.red_s[v][lane] : __int_as_float(0xff800000);
  bi = lane < nwarps ? ps.red_i[v][lane] : n;
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(bs, bi, os, oi);
  }
}

// One cluster block's partial of one exchange: the pick's (score, lowest
// index) per view and its "any feasible" bits, or the affinity pass's max
// and min in s[0], s[1].
struct ClusterSlot {
  float s[2];
  int i[2];
  int any;
};

// Warp 0 of every block: the CB blocks' partials in `slot` (this block's
// buffer of the exchange), read through distributed shared memory after
// the cluster barrier, reduced to lane 0. Lane r reads block r.
__device__ __forceinline__ ClusterSlot exchange_pick(cg::cluster_group& cluster,
                                                     ClusterSlot* slot,
                                                     int n) {
  const int lane = threadIdx.x & 31;
  const int CB = static_cast<int>(cluster.num_blocks());
  ClusterSlot w{{__int_as_float(0xff800000), __int_as_float(0xff800000)},
                {n, n},
                0};
  if (lane < CB) {
    const ClusterSlot* rs = cluster.map_shared_rank(slot, lane);
    w.s[0] = rs->s[0];
    w.s[1] = rs->s[1];
    w.i[0] = rs->i[0];
    w.i[1] = rs->i[1];
    w.any = rs->any;
  }
  for (int v = 0; v < 2; ++v)
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, w.s[v], off);
      const int oi = __shfl_down_sync(0xffffffffu, w.i[v], off);
      take_better(w.s[v], w.i[v], os, oi);
    }
  w.any = (__any_sync(0xffffffffu, w.any & 1) ? 1 : 0) |
          (__any_sync(0xffffffffu, w.any & 2) ? 2 : 0);
  return w;
}

// Called by every thread of every block of the cluster with the same task
// (kernels 1 and 3): this block evaluates its nodes [lo, hi) from its slice of the
// live state (`lv`), then the cluster exchanges the blocks' partials
// through `slot`. The pick is valid in thread 0 only.
template <bool WIDE>
__device__ Pick cluster_pick(cg::cluster_group& cluster, const NodeEnv& e,
                             const LiveView& lv, const Task<WIDE>& t, bool is_tgt,
                             PickShared& ps, int lo, int hi, ClusterSlot* slot,
                             const AffEnv* ae = nullptr,
                             const AffShared* as = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float best[2];
  int bidx[2];
  bool found[2];
  pick_rows(e, lv, t, is_tgt, lo, hi, CBLOCK, ae, as, best, bidx, found);
  if (lane == 0)
    for (int v = 0; v < 2; ++v) {
      ps.red_s[v][warp] = best[v];
      ps.red_i[v][warp] = bidx[v];
    }
  const bool any_now = __syncthreads_or(found[0]);
  const bool any_fut = __syncthreads_or(found[1]);
  if (warp < 2) {
    float bs;
    int bi;
    pick_warps(ps, CWARPS, e.N, bs, bi);
    if (lane == 0) {
      slot->s[warp] = bs;
      slot->i[warp] = bi;
      if (warp == 0) slot->any = (any_now ? 1 : 0) | (any_fut ? 2 : 0);
    }
  }
  cluster.sync();
  Pick pk{0, 0, false, false};
  if (warp == 0) {
    const ClusterSlot w = exchange_pick(cluster, slot, e.N);
    pk = Pick{w.i[0], w.i[1], (w.any & 1) != 0, (w.any & 2) != 0};
  }
  return pk;
}

// Called by every thread of every block of the cluster (kernels 1 and 3):
// the affinity pass of slot s over this block's nodes [lo, hi), then the raw
// score's max and min over the cluster through `slot`; leaves the
// normalisation in `as`.
__device__ void cluster_aff_eval(cg::cluster_group& cluster,
                                 const AffEnv& ae, int N, int s,
                                 AffShared& as, float* red, int lo, int hi,
                                 ClusterSlot* slot) {
  const float BIG = static_cast<float>(3.4e38);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) aff_lists(ae, s, as);
  __syncthreads();
  float mx, mn;
  aff_pass(ae, N, as, red, lo, hi, CBLOCK, mx, mn);
  if (threadIdx.x == 0) {
    slot->s[0] = mx;
    slot->s[1] = mn;
  }
  cluster.sync();
  if (threadIdx.x < 32) {
    const int CB = static_cast<int>(cluster.num_blocks());
    mx = -BIG;
    mn = BIG;
    if (lane < CB) {
      const ClusterSlot* rs = cluster.map_shared_rank(slot, lane);
      mx = rs->s[0];
      mn = rs->s[1];
    }
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
    }
    if (lane == 0) aff_norm(as, mx, mn);
  }
  __syncthreads();
}

// ---- the shard-local kernels (shard_candidates.cu, shard_wave.cu) --------

// One task of a shard-local attempt, read from device memory: element k of
// the request column `req` lies at k * rstride (R dims, then the GPU
// request), element k of the task column `task` (pref, tmpl, grp, voln,
// volok, rev: shard_placer.TASK_FIELDS) at k * tstride.
template <bool WIDE>
struct ShardTask {
  ReqRow<WIDE> rr;
  float gr, grm;  // the GPU request, and it less EPS_FIT
  int pref, grp, voln;
  bool volok, rev, is_tgt;
  const float* trow;   // the task's template row of tstat
  const float* tsrow;  // ... of tscore
  const float* narow;  // ... of nascore
  const float* orrow;  // its OR group's row of orfeas (row 0 without one)
};

template <bool WIDE>
__device__ __forceinline__ ShardTask<WIDE> load_shard_task(
    const NodeEnv& e, const float* req, int rstride, const int* task,
    int tstride, bool is_tgt) {
  const float EPS_FIT = static_cast<float>(1e-5);
  const int N = e.N, stride = tstride;
  ShardTask<WIDE> t;
  t.rr.load(req, rstride, e.R);
  t.gr = e.G > 0 ? req[e.R * rstride] : 0.0f;
  t.grm = t.gr - EPS_FIT;
  t.pref = task[0];
  const int tmpl = task[stride];
  t.grp = task[2 * stride];
  t.voln = task[3 * stride];
  t.volok = task[4 * stride] > 0;
  t.rev = task[5 * stride] > 0;
  t.is_tgt = is_tgt;
  t.trow = e.tstat + static_cast<size_t>(tmpl) * N;
  t.tsrow = e.tscore + static_cast<size_t>(tmpl) * N;
  t.narow = e.nascore + static_cast<size_t>(tmpl) * N;
  t.orrow = e.orfeas + static_cast<size_t>(t.grp > 0 ? t.grp : 0) * N;
  return t;
}

struct RowEval {
  bool now, fut;  // feasible on idle / on future idle
  float score;
};

// Row i for task t: the column arithmetic of _shard_cand_kernel and
// _shard_wave_kernel before their picks (shard_placer.row_eval), in the
// reference's order. The future view uses the scan association
// ((idle + releasing) - pipelined) - pipe_extra.
template <bool WIDE>
__device__ __forceinline__ RowEval shard_row(const NodeEnv& e,
                                             const float* rel,
                                             const float* pip,
                                             const ShardTask<WIDE>& t, int i) {
  const float EPS_FIT = static_cast<float>(1e-5);
  const int N = e.N;
  // static feasibility: the node_ok conjunction of the scan branch
  bool sfeas = t.trow[i] > 0.0f;
  sfeas = sfeas && !(e.blocknr[i] > 0.0f && !t.rev) && !(e.blockall[i] > 0.0f);
  sfeas = sfeas && (t.orrow[i] > 0.0f || t.grp < 0);
  sfeas = sfeas && t.volok && (t.voln < 0 || i == t.voln);
  sfeas = sfeas && (!(e.locked[i] > 0.0f) || t.is_tgt);
  bool fit_now = true, fit_fut = true;
  for (int r = 0; r < e.R; ++r) {
    const size_t k = static_cast<size_t>(r) * N + i;
    const float idle = e.idle[k];
    const float fut = fmaxf(((idle + rel[k]) - pip[k]) - e.pipe[k], 0.0f);
    fit_now = fit_now && t.rr[r] <= idle + EPS_FIT;
    fit_fut = fit_fut && t.rr[r] <= fut + EPS_FIT;
  }
  bool shared = sfeas && (e.cnt[i] + e.pods[i]) < e.maxp[i];
  if (e.G > 0) {
    bool ok = t.gr <= 0.0f;
    for (int g = 0; g < e.G; ++g) {
      const size_t k = static_cast<size_t>(g) * N + i;
      ok = ok || (e.gidle0[k] - e.gpux[k]) >= t.grm;
    }
    shared = shared && ok;
  }
  // the reference's float32 addition order
  float score = dyn_score<WIDE>(e, global_view(e), i, t.rr);
  score = score + t.tsrow[i];
  score = score + (t.narow[i] + (t.rev ? e.bonus[i] : 0.0f));
  score = score + ((t.pref >= 0 && i == t.pref) ? 100.0f : 0.0f);
  return {shared && fit_now, shared && fit_fut, score};
}

// a view's running candidate: the best masked score, the lowest global row
// at it, and the feasible rows at it
struct Cand {
  float s;
  int i;
  int n;
};

// a higher score wins; equal scores keep the lower row and add their counts
__device__ __forceinline__ void merge(Cand& a, float s, int i, int n) {
  if (s > a.s) {
    a.s = s;
    a.i = i;
    a.n = n;
  } else if (s == a.s) {
    a.i = i < a.i ? i : a.i;
    a.n += n;
  }
}

// the saved node columns of one gang section: node id + idle, pipe [R] +
// pods + GPU cards [G] per placement
struct SaveArea {
  int* node;   // [M]
  float* val;  // [M, stride]
  int stride;  // 2R + 1 + G
};

// Thread 0 only: take the task from `node` (idle when do_alloc, else the
// pipelined extra), after saving the node's column in save slot `sv`.
// Returns the charged GPU card or -1.
template <bool WIDE>
__device__ int commit(const NodeEnv& e, const LiveView& lv, const Task<WIDE>& t,
                      int node, bool do_alloc, const SaveArea& save, int sv) {
  const float EPS_FIT = static_cast<float>(1e-5);
  const int N = e.N, R = e.R, G = e.G;
  float* col = save.val + sv * save.stride;
  save.node[sv] = node;
  for (int r = 0; r < R; ++r) {
    col[r] = lv.idle[lv.k(r, node)];
    col[R + r] = lv.pipe[lv.k(r, node)];
  }
  col[2 * R] = lv.pods[lv.k(0, node)];
  for (int g = 0; g < G; ++g) col[2 * R + 1 + g] = lv.gpux[lv.k(g, node)];
  if (do_alloc) {
    for (int r = 0; r < R; ++r)
      lv.idle[lv.k(r, node)] = lv.idle[lv.k(r, node)] - t.rr[r];
  } else {
    for (int r = 0; r < R; ++r)
      lv.pipe[lv.k(r, node)] = lv.pipe[lv.k(r, node)] + t.rr[r];
  }
  lv.pods[lv.k(0, node)] = lv.pods[lv.k(0, node)] + 1.0f;
  int card = -1;
  if (G > 0 && t.gr > 0.0f) {
    // lowest fitting card on the chosen node (pick_gpu_row)
    const float grm = t.gr - EPS_FIT;
    for (int g = 0; g < G && card < 0; ++g)
      if ((e.gidle0[g * N + node] - lv.gpux[lv.k(g, node)]) >= grm) card = g;
    if (card >= 0)
      lv.gpux[lv.k(card, node)] = lv.gpux[lv.k(card, node)] + t.gr;
  }
  return card;
}

// Thread 0 only: restore the first `nsave` saved columns, newest first.
__device__ void restore(const NodeEnv& e, const LiveView& lv,
                        const SaveArea& save, int nsave) {
  const int R = e.R, G = e.G;
  for (int sv = nsave - 1; sv >= 0; --sv) {
    const int node = save.node[sv];
    const float* col = save.val + sv * save.stride;
    for (int r = 0; r < R; ++r) {
      lv.idle[lv.k(r, node)] = col[r];
      lv.pipe[lv.k(r, node)] = col[R + r];
    }
    lv.pods[lv.k(0, node)] = col[2 * R];
    for (int g = 0; g < G; ++g) lv.gpux[lv.k(g, node)] = col[2 * R + 1 + g];
  }
}

// The live node state [2R + 1 + G, N] as four arrays: idle rows, pipe
// rows, pods, GPU card rows.
template <typename T>
struct StateRows {
  T* idle;
  T* pipe;
  T* pods;
  T* gpux;
  __device__ __forceinline__ T* row(int R, int N, int k) const {
    if (k < R) return idle + k * N;
    if (k < 2 * R) return pipe + (k - R) * N;
    if (k == 2 * R) return pods;
    return gpux + (k - 2 * R - 1) * N;
  }
};

// Block-wide: this cluster block's nodes [lo, hi) of the state `in` into
// its shared-memory slice `st` [2R + 1 + G, cap] ...
__device__ void load_slice(const NodeEnv& e, StateRows<const float> in,
                           float* st, int cap, int lo, int hi) {
  const int col = 2 * e.R + 1 + e.G;
  for (int j = threadIdx.x; j < col * cap; j += CBLOCK) {
    const int row = j / cap, i = lo + (j - row * cap);
    if (i < hi) st[j] = in.row(e.R, e.N, row)[i];
  }
}

// ... and back into the live output rows of `e`.
__device__ void store_slice(const NodeEnv& e, const float* st, int cap,
                            int lo, int hi) {
  const int col = 2 * e.R + 1 + e.G;
  const StateRows<float> out{e.idle, e.pipe, e.pods, e.gpux};
  for (int j = threadIdx.x; j < col * cap; j += CBLOCK) {
    const int row = j / cap, i = lo + (j - row * cap);
    if (i < hi) out.row(e.R, e.N, row)[i] = st[j];
  }
}

// returned by launch_cluster when the card cannot run one cluster of the
// asked size, and when the kernel's static shared memory is over the
// allowance its wrapper's shared-memory limit leaves for it
constexpr int NO_CLUSTER = -1;
constexpr int STATIC_OVER = -2;

// What launch_cluster has set up for one kernel on one device: the dynamic
// shared memory its attribute allows (never lowered, so a shape accepted
// once stays launchable), whether it may run clusters past the portable 8
// blocks, and the cluster shapes (CB, smem) the card has accepted. The
// attribute calls and the occupancy query are host work a launch of a
// tenth of a millisecond feels, and their answers do not change, so each
// is made once.
struct ClusterSetup {
  int dev;
  const void* kernel;
  size_t smem_allowed;
  bool wide;
};
struct ClusterShape {
  int dev;
  const void* kernel;
  int CB;
  size_t smem;
};
constexpr int SETUP_SLOTS = 16;
constexpr int SHAPE_SLOTS = 64;

struct ClusterCache {
  std::mutex mu;
  ClusterSetup setup[SETUP_SLOTS];
  int n_setup = 0;
  ClusterShape shape[SHAPE_SLOTS];
  int n_shape = 0;  // shapes recorded; the newest replaces the oldest
};

inline ClusterCache& cluster_cache() {
  static ClusterCache cache;
  return cache;
}

// Set up `kernel` on device `dev` for clusters of CB blocks with `smem`
// bytes of dynamic shared memory and ask the card whether it runs one;
// `cfg` is the launch's configuration. Called with the cache locked, on a
// shape not yet accepted. Returns 0, a CUDA error code, NO_CLUSTER or
// STATIC_OVER.
inline int cluster_setup(ClusterCache& c, const void* kernel, int dev,
                         int CB, size_t smem, size_t static_max,
                         const cudaLaunchConfig_t& cfg) {
  cudaError_t err;
  ClusterSetup* s = nullptr;
  for (int k = 0; k < c.n_setup; ++k)
    if (c.setup[k].dev == dev && c.setup[k].kernel == kernel) s = &c.setup[k];
  if (s == nullptr) {
    if (c.n_setup == SETUP_SLOTS) return static_cast<int>(cudaErrorUnknown);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fa.sharedSizeBytes > static_max) return STATIC_OVER;
    s = &c.setup[c.n_setup++];
    *s = ClusterSetup{dev, kernel, 48 * 1024, false};
  }
  if (smem > s->smem_allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    s->smem_allowed = smem;
  }
  if (CB > 8 && !s->wide) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    s->wide = true;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return NO_CLUSTER;
  c.shape[c.n_shape % SHAPE_SLOTS] = ClusterShape{dev, kernel, CB, smem};
  ++c.n_shape;
  return 0;
}

// Launch `kernel` as one cluster of CB blocks of CBLOCK threads with `smem`
// bytes of dynamic shared memory a block, the kernel's static shared
// memory being at most `static_max` bytes; 0, a CUDA error code,
// NO_CLUSTER when the card cannot run the cluster, or STATIC_OVER.
template <typename... KT, typename... AT>
int launch_cluster(void (*kernel)(KT...), int CB, size_t smem,
                   size_t static_max, cudaStream_t stream, AT... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CB, 1, 1);
  cfg.blockDim = dim3(CBLOCK, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* key = reinterpret_cast<const void*>(kernel);
  {
    ClusterCache& c = cluster_cache();
    std::lock_guard<std::mutex> lock(c.mu);
    bool known = false;
    const int n = c.n_shape < SHAPE_SLOTS ? c.n_shape : SHAPE_SLOTS;
    for (int k = 0; k < n && !known; ++k) {
      const ClusterShape& sh = c.shape[k];
      known = sh.dev == dev && sh.kernel == key && sh.CB == CB &&
              sh.smem == smem;
    }
    if (!known) {
      const int rc = cluster_setup(c, key, dev, CB, smem, static_max, cfg);
      if (rc != 0) return rc;
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace placement
