// The placement step shared by the round placers: one task slot placed on
// the node axis by one thread block.
//
// Port of volcano_tpu/ops/pallas_place.py `_make_attempt` (feasibility ->
// score -> lowest-index argmax -> commit) and `_dyn_score`, used by
// round_placer.cu (`_batch_kernel`) and dyn_placer.cu (`_dyn_kernel`).
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
// both views and whether any node is feasible in each.
__device__ Pick block_pick(const NodeEnv& e, const Task& t, bool is_tgt,
                           PickShared& ps) {
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
    const bool feas[2] = {shared && fit_now, shared && fit_fut};
    float sc = NEG;
    if (feas[0] || feas[1]) {
      sc = dyn_score(e, i, t.rr);
      sc = sc + e.tscore[t.tmpl * N + i];
      sc = sc + (e.nascore[t.tmpl * N + i] + (t.rev ? e.bonus[i] : 0.0f));
      sc = sc + ((t.pref >= 0 && i == t.pref) ? 100.0f : 0.0f);
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
