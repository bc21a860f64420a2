// The placement step shared by the round placers: one task slot placed on
// the node axis by one thread block.
//
// Port of volcano_tpu/ops/pallas_place.py `_make_attempt` (feasibility ->
// score -> lowest-index argmax -> commit) and `_dyn_score`, used by
// round_placer.cu (`_batch_kernel`) and dyn_placer.cu (`_dyn_kernel`), and
// of its pod-affinity extension (`_read_aff_env`, `_aff_eval`,
// `_aff_commit`, pallas_place.py:186-331). At the end, the row evaluation
// of the shard-local kernels (`shard_row`), which shard_candidates.cu
// (`_shard_cand_kernel`) and shard_wave.cu (`_shard_wave_kernel`) share.
//
// - The node-axis state (idle, pipe [R, N], pods [1, N], GPU cards [G, N])
//   lives in global memory (L2 at the sizes the cycle runs).
// - block_pick: thread t evaluates the nodes i = t (mod BLOCK): feasibility
//   on idle ("now") and on future idle, and the score. A block reduction
//   finds, for each view, the highest masked score and the lowest node
//   index at that score, the reference's tie-break.
// - commit (thread 0 only): saves the chosen node's column, then takes the
//   task's request from it and picks the lowest fitting GPU card.
// - restore (thread 0 only): puts saved columns back, newest first, when a
//   gang is discarded. Subtracting back would not do: (a - r) + r != a in
//   float32.
// - Pod affinity (AffEnv, when the cycle compiles it in): the live counts
//   cnt [SK, N], tot [SK, 1] and anti [ETA, N] are global memory too.
//   Each attempt first runs aff_eval: thread 0 lists the task's terms in
//   shared memory (its required pairs, own anti terms, preferred pairs, and
//   only the ETA / SEL rows the task matches: the rows it does not match
//   add `false` or 0 * x, and every sum is integer-valued, so skipping them
//   changes no bit), then one block pass computes each node's affinity mask
//   and raw preferred score into a scratch row and reduces the raw score's
//   max and min over the live nodes. block_pick, the second pass, ANDs the
//   mask into both views and adds weight * the min-max normalised score
//   last. aff_apply adds (or, on a gang discard, takes back) one placement's
//   domain-membership rows, block-wide. The discard takes back instead of
//   copying back: the counts are integer-valued float32 far below 2^24,
//   so (c + 1) - 1 == c exactly, and an undo costs what its commit cost,
//   where a copy-back would save SK x N + ETA x N floats every section.
//
// Bit-exactness with the reference: build with --fmad=false and without
// fast math, so no multiply-add is contracted and division and sqrt are
// IEEE; every sum over R folds in index order from 0; every constant is
// rounded from the double the reference writes, as JAX rounds it.

#pragma once

#include <cuda_runtime.h>

namespace placement {

constexpr int BLOCK = 1024;
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_R = 8;
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

// one slot's scalars, read by every thread
struct Task {
  float rr[MAX_R];
  float gr;
  int tmpl, grp, voln, pref;
  bool volok, rev;
};

__device__ __forceinline__ Task load_task(const SlotEnv& se, const NodeEnv& e,
                                          int s) {
  Task t;
  for (int r = 0; r < e.R; ++r) t.rr[r] = se.resreq[r * se.S + s];
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

// pallas_place._dyn_score for node i, in the reference's operation order
__device__ float dyn_score(const NodeEnv& e, int i, const float* rr) {
  const float EPS_DIV = static_cast<float>(1e-9);
  const float OVER = static_cast<float>(1.0 + 1e-6);
  const int N = e.N, R = e.R;
  float alloc[MAX_R], used[MAX_R];
  for (int r = 0; r < R; ++r) {
    alloc[r] = e.alloc[r * N + i];
    used[r] = alloc[r] - e.idle[r * N + i];
  }
  float score = 0.0f;
  if (e.w_bin != 0.0f) {
    float wsum = 0.0f, fsum = 0.0f;
    bool over = false;
    for (int r = 0; r < R; ++r) {
      const bool app = rr[r] > 0.0f && alloc[r] > 0.0f;
      const float frac =
          app ? (used[r] + rr[r]) / fmaxf(alloc[r], EPS_DIV) : 0.0f;
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
      const float cap = fmaxf(alloc[r], EPS_DIV);
      const float free_frac = ((alloc[r] - used[r]) - rr[r]) / cap;
      const bool counted = alloc[r] > 0.0f;
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
      const float cap = fmaxf(alloc[r], EPS_DIV);
      const float used_frac = (used[r] + rr[r]) / cap;
      const bool counted = alloc[r] > 0.0f;
      n += counted ? 1 : 0;
      s = s + clip01(used_frac) * (counted ? 1.0f : 0.0f);
    }
    n = n > 1 ? n : 1;
    score = score + e.w_most * ((s / static_cast<float>(n)) * 100.0f);
  }
  if (e.w_bal != 0.0f) {
    float frac[MAX_R], counted[MAX_R];
    float nsum = 0.0f, fsum = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float cap = fmaxf(alloc[r], EPS_DIV);
      frac[r] = clip01((used[r] + rr[r]) / cap);
      counted[r] = alloc[r] > 0.0f ? 1.0f : 0.0f;
      nsum = nsum + counted[r];
      fsum = fsum + frac[r] * counted[r];
    }
    const float n = fmaxf(nsum, 1.0f);
    const float mean = fsum / n;
    float vsum = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float d = frac[r] - mean;
      vsum = vsum + (d * d) * counted[r];
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

// Called by every thread: the first pass of an attempt. Writes each node's
// affinity mask and raw preferred score to the scratch rows and leaves the
// normalisation in `as` (pallas_place._aff_eval).
__device__ void aff_eval(const AffEnv& ae, int N, int s, AffShared& as,
                         float* red) {
  const float BIG = static_cast<float>(3.4e38);
  const float EPS_DIV = static_cast<float>(1e-9);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) aff_lists(ae, s, as);
  __syncthreads();
  float mx = -BIG, mn = BIG;
  for (int i = threadIdx.x; i < N; i += BLOCK) {
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
    float raw = 0.0f;
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
    mx = red[lane];
    mn = red[WARPS + lane];
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
    }
    if (lane == 0) {
      const float span = mx - mn;
      as.mn = mn;
      as.q = 100.0f / fmaxf(span, EPS_DIV);
      as.span_pos = span > 0.0f;
    }
  }
  __syncthreads();
}

// Called by every thread: add `delta` (1 on a placement, -1 to take it back
// on a gang discard) to the domain-membership rows of slot s's task placed
// on `node` (pallas_place._aff_commit). Adds to members only: the
// reference's + 0.0 elsewhere changes no count (counts are never -0.0).
// `listed`: the term lists in `as` are slot s's already (a commit right
// after the slot's aff_eval).
__device__ void aff_apply(const AffEnv& ae, int N, int s, int node,
                          float delta, AffShared& as, bool listed) {
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
    for (int i = threadIdx.x; i < N; i += BLOCK)
      if (dom[i] == d) row[i] = row[i] + delta;
    if (threadIdx.x == 0) ae.tot[sk] = ae.tot[sk] + delta;
  }
  for (int k = 0; k < as.nown; ++k) {
    const int e = as.own_e[k];
    const int* dom = ae.eta_dom + e * N;
    const int d = dom[node];
    if (d < 0) continue;
    float* row = ae.anti_cnt + e * N;
    for (int i = threadIdx.x; i < N; i += BLOCK)
      if (dom[i] == d) row[i] = row[i] + delta;
  }
  __syncthreads();
}

// Block-wide copy of the input affinity counts into the live outputs.
__device__ void copy_aff(const AffEnv& ae, int N, const float* cnt_in,
                         const float* tot_in, const float* anti_in) {
  for (int j = threadIdx.x; j < ae.SK * N; j += BLOCK) ae.cnt[j] = cnt_in[j];
  for (int j = threadIdx.x; j < ae.SK; j += BLOCK) ae.tot[j] = tot_in[j];
  for (int j = threadIdx.x; j < ae.ETA * N; j += BLOCK)
    ae.anti_cnt[j] = anti_in[j];
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

// Called by every thread of the block with the same task: the best node of
// both views and whether any node is feasible in each. With `ae` (pod
// affinity on), after aff_eval: the affinity mask joins both views and
// weight * the normalised preferred score joins the score, last.
__device__ Pick block_pick(const NodeEnv& e, const Task& t, bool is_tgt,
                           PickShared& ps, const AffEnv* ae = nullptr,
                           const AffShared* as = nullptr) {
  const float EPS_FIT = static_cast<float>(1e-5);
  const float NEG = static_cast<float>(-1e30);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = e.N, R = e.R, G = e.G;
  const bool gpu = G > 0;
  const float grm = t.gr - EPS_FIT;

  const float lowest = __int_as_float(0xff800000);  // -inf
  float best[2] = {lowest, lowest};
  int bidx[2] = {N, N};
  bool found[2] = {false, false};
  for (int i = tid; i < N; i += BLOCK) {
    bool sf = e.tstat[t.tmpl * N + i] > 0.0f;
    sf = sf && !(e.blocknr[i] > 0.0f && !t.rev) && !(e.blockall[i] > 0.0f);
    if (t.grp >= 0) sf = sf && e.orfeas[t.grp * N + i] > 0.0f;
    sf = sf && t.volok && (t.voln < 0 || i == t.voln);
    sf = sf && (!(e.locked[i] > 0.0f) || is_tgt);
    bool shared = sf && (e.cnt[i] + e.pods[i]) < e.maxp[i];
    if (gpu && !(t.gr <= 0.0f)) {
      bool any = false;
      for (int g = 0; g < G; ++g)
        any = any || (e.gidle0[g * N + i] - e.gpux[g * N + i]) >= grm;
      shared = shared && any;
    }
    bool fit_now = true, fit_fut = true;
    for (int r = 0; r < R; ++r) {
      const float idle_r = e.idle[r * N + i];
      const float fut_r =
          fmaxf((idle_r + e.relmp[r * N + i]) - e.pipe[r * N + i], 0.0f);
      fit_now = fit_now && t.rr[r] <= idle_r + EPS_FIT;
      fit_fut = fit_fut && t.rr[r] <= fut_r + EPS_FIT;
    }
    if (ae != nullptr) shared = shared && ae->ok[i] > 0.0f;
    const bool feas[2] = {shared && fit_now, shared && fit_fut};
    float sc = NEG;
    if (feas[0] || feas[1]) {
      sc = dyn_score(e, i, t.rr);
      sc = sc + e.tscore[t.tmpl * N + i];
      sc = sc + (e.nascore[t.tmpl * N + i] + (t.rev ? e.bonus[i] : 0.0f));
      sc = sc + ((t.pref >= 0 && i == t.pref) ? 100.0f : 0.0f);
      if (ae != nullptr) {
        const float norm = as->span_pos ? (ae->raw[i] - as->mn) * as->q : 0.0f;
        sc = sc + ae->weight * norm;
      }
    }
    for (int v = 0; v < 2; ++v) {
      take_better(best[v], bidx[v], feas[v] ? sc : NEG, i);
      found[v] = found[v] || feas[v];
    }
  }
  for (int v = 0; v < 2; ++v) {
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best[v], off);
      const int oi = __shfl_down_sync(0xffffffffu, bidx[v], off);
      take_better(best[v], bidx[v], os, oi);
    }
    if (lane == 0) {
      ps.red_s[v][warp] = best[v];
      ps.red_i[v][warp] = bidx[v];
    }
  }
  Pick pk;
  pk.any_now = __syncthreads_or(found[0]);
  pk.any_fut = __syncthreads_or(found[1]);
  if (warp < 2) {
    const int v = warp;
    float bs = ps.red_s[v][lane];
    int bi = ps.red_i[v][lane];
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      take_better(bs, bi, os, oi);
    }
    if (lane == 0) ps.pick_i[v] = bi;
  }
  __syncthreads();
  pk.node_now = ps.pick_i[0];
  pk.node_fut = ps.pick_i[1];
  return pk;
}

// ---- the shard-local kernels (shard_candidates.cu, shard_wave.cu) --------

// One task of a shard-local attempt, read from device memory: element k of
// the request column `req` and of the task column `task` (pref, tmpl, grp,
// voln, volok, rev: shard_placer.TASK_FIELDS) lies at k * stride.
struct ShardTask {
  float rr[MAX_R];
  float gr, grm;  // the GPU request, and it less EPS_FIT
  int pref, grp, voln;
  bool volok, rev, is_tgt;
  const float* trow;   // the task's template row of tstat
  const float* tsrow;  // ... of tscore
  const float* narow;  // ... of nascore
  const float* orrow;  // its OR group's row of orfeas (row 0 without one)
};

__device__ __forceinline__ ShardTask load_shard_task(const NodeEnv& e,
                                                     const float* req,
                                                     const int* task,
                                                     int stride, bool is_tgt) {
  const float EPS_FIT = static_cast<float>(1e-5);
  const int N = e.N;
  ShardTask t;
  for (int r = 0; r < e.R; ++r) t.rr[r] = req[r * stride];
  t.gr = e.G > 0 ? req[e.R * stride] : 0.0f;
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
__device__ __forceinline__ RowEval shard_row(const NodeEnv& e,
                                             const float* rel,
                                             const float* pip,
                                             const ShardTask& t, int i) {
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
  float score = dyn_score(e, i, t.rr);
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
__device__ int commit(const NodeEnv& e, const Task& t, int node, bool do_alloc,
                      const SaveArea& save, int sv) {
  const float EPS_FIT = static_cast<float>(1e-5);
  const int N = e.N, R = e.R, G = e.G;
  float* col = save.val + sv * save.stride;
  save.node[sv] = node;
  for (int r = 0; r < R; ++r) {
    col[r] = e.idle[r * N + node];
    col[R + r] = e.pipe[r * N + node];
  }
  col[2 * R] = e.pods[node];
  for (int g = 0; g < G; ++g) col[2 * R + 1 + g] = e.gpux[g * N + node];
  if (do_alloc) {
    for (int r = 0; r < R; ++r)
      e.idle[r * N + node] = e.idle[r * N + node] - t.rr[r];
  } else {
    for (int r = 0; r < R; ++r)
      e.pipe[r * N + node] = e.pipe[r * N + node] + t.rr[r];
  }
  e.pods[node] = e.pods[node] + 1.0f;
  int card = -1;
  if (G > 0 && t.gr > 0.0f) {
    // lowest fitting card on the chosen node (pick_gpu_row)
    const float grm = t.gr - EPS_FIT;
    for (int g = 0; g < G && card < 0; ++g)
      if ((e.gidle0[g * N + node] - e.gpux[g * N + node]) >= grm) card = g;
    if (card >= 0) e.gpux[card * N + node] = e.gpux[card * N + node] + t.gr;
  }
  return card;
}

// Thread 0 only: restore the first `nsave` saved columns, newest first.
__device__ void restore(const NodeEnv& e, const SaveArea& save, int nsave) {
  const int N = e.N, R = e.R, G = e.G;
  for (int sv = nsave - 1; sv >= 0; --sv) {
    const int node = save.node[sv];
    const float* col = save.val + sv * save.stride;
    for (int r = 0; r < R; ++r) {
      e.idle[r * N + node] = col[r];
      e.pipe[r * N + node] = col[R + r];
    }
    e.pods[node] = col[2 * R];
    for (int g = 0; g < G; ++g) e.gpux[g * N + node] = col[2 * R + 1 + g];
  }
}

// Block-wide copy of the input node state into the live output buffers.
__device__ void copy_state(const NodeEnv& e, const float* idle_in,
                           const float* pipe_in, const float* pods_in,
                           const float* gpux_in) {
  const int N = e.N;
  for (int j = threadIdx.x; j < e.R * N; j += BLOCK) {
    e.idle[j] = idle_in[j];
    e.pipe[j] = pipe_in[j];
  }
  for (int j = threadIdx.x; j < N; j += BLOCK) e.pods[j] = pods_in[j];
  for (int j = threadIdx.x; j < e.G * N; j += BLOCK) e.gpux[j] = gpux_in[j];
}

}  // namespace placement
