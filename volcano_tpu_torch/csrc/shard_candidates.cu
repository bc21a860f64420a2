// Shard-local candidate search: one placement attempt over each shard's rows.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_place.py
// `_shard_cand_kernel` (built by `make_shard_candidate_placer`). The plain
// PyTorch version of the same function, the argument order and the
// cross-shard combine are in volcano_tpu_torch/ops/shard_placer.py.
//
// The sharded allocate cycle splits the node axis of N rows into D shards
// of NL = N / D rows and asks, once per placement attempt, each shard for
// its candidate in the "now" view (fit on idle) and the "future" view (fit
// on future idle): the best score, the lowest global row at that score,
// whether any row is feasible, and the raw count of feasible rows at the
// best score. The reference launches its kernel once per shard under
// shard_map; here one launch covers every shard of the device.
//
// What bounds it: each launch reads about 21 float rows of N (0.86 MB at
// N = 10,240 with two resource dims), 0.26 us at 3.35 TB/s, and does a few
// hundred thousand float operations. One block a shard would walk 10,240
// rows on one SM at D = 1 (about 0.032 ms); and a combine of the D
// candidates in the cycle costs ten small device operations an attempt,
// more host time than the kernel's device time.
//
// Design: a split-row grid that also combines.
// - Grid = B x D blocks of T threads (T = 128 or 256). Block (b, d) takes
//   the ROWS = T or 2T rows [d * NL + b * ROWS, ...) of shard d, cut at
//   the shard's end, B = ceil(NL / ROWS). It reads the global [.., N]
//   tensors in place (row stride N): no per-shard copies.
// - Each thread keeps, per view, its best (score, lowest row) and the
//   feasible count at that score; one block reduction (warp shuffles, then
//   one warp over the warps' partials) merges them: a higher score wins,
//   equal scores keep the lower row and add their counts (placement.cuh
//   merge). A row that is not feasible scores NEG = -1e30, so when no row
//   of a shard is feasible every row ties at NEG and the index is the
//   shard's first row, with a count of 0, as in the reference.
// - Each block writes its partial to a scratch [D, B], makes it visible
//   (__threadfence) and takes a ticket from a device counter (atomicAdd).
//   The block that takes the last ticket merges the partials of each shard
//   (a warp a shard), writes the per-shard outputs, then combines the D
//   shards as the reference's `_combine` does (the winner of each view,
//   whether any row is feasible, the raw ties at the global best) and puts
//   the counter back to 0 for the next launch. Integer counts and max with
//   the lowest row are exact, so the result is the same bits whatever
//   order the blocks ran in. The cycle needs no combine of its own.
//   A cluster a shard with a distributed-shared-memory merge would cap a
//   shard at 16 blocks (640 rows a block at N = 10,240) and need the D
//   clusters combined anyway; the ticket takes any D x B grid.
// - The task's scalars (request, GPU request, template, OR group, volume
//   pin, preferred node, revocable and target flags) are read from device
//   memory: the host never has to know them, so an attempt never waits.
// - A row's feasibility and score are placement.cuh's shard_row (shared
//   with kernel 5, csrc/shard_wave.cu, so both give the same bits for the
//   same row); the future view uses the scan association ((idle +
//   releasing) - pipelined) - pipe_extra, not the fused placers'
//   precomputed releasing - pipelined (they can differ by an ulp). Built
//   with --fmad=false and without fast math, as every kernel of the port.
// - The counter and the scratch belong to the device: launches that share
//   them run one after another (one stream), as the cycle's do.

#include <climits>

#include "placement.cuh"

namespace {

using namespace placement;

// pointer slots of shard_candidates_launch: the inputs in the order of
// shard_placer.ShardArgs, then the outputs, then the scratch and counter
enum Ptr {
  P_REQ, P_TASK, P_ISTGT, P_TSTAT, P_TSCORE, P_NASCORE, P_BLOCKNR,
  P_BLOCKALL, P_BONUS, P_LOCKED, P_ORFEAS, P_REL, P_PIP, P_ALLOC, P_CNT,
  P_MAXP, P_GIDLE0, P_IDLE, P_PIPE, P_PODS, P_GPUX,
  // outputs: scores f32[2, D], (index, found, ties) i32[3, 2, D], the
  // combined (index, ties) i32[2, 2] and found bool[2]
  O_SCORE, O_INTS, O_BEST, O_FOUND,
  // the blocks' partials Part[D, B] and the ticket counter u32[1] (0)
  S_PART, S_TICKET,
  N_PTRS
};

// integer dimensions of shard_candidates_launch
enum Dim { D_D, D_NL, D_R, D_G, D_THREADS, D_ROWS, N_DIMS };

// one block's partial: per view the best score, the lowest row at it and
// the feasible rows at it; bit v of any: some row is feasible in view v
struct Part {
  float s[2];
  int i[2];
  int n[2];
  int any, pad;
};

struct Args {
  NodeEnv env;          // alloc, cnt, maxp, gidle0, idle, pipe, pods, gpux
  const float* req;     // [1, R (+1)]
  const int* task;      // [1, 6]
  const int* istgt;     // [1, 1]
  const float* rel;     // [R, N]
  const float* pip;     // [R, N]
  float* score_o;
  int* ints_o;
  int* best_o;
  bool* found_o;
  Part* part;
  unsigned int* ticket;
  int D, NL, ROWS;
};

// WIDE: built for R > REG_R resource dims (placement.cuh)
template <int T, bool WIDE>
__global__ void __launch_bounds__(T)
    shard_cand_kernel(const __grid_constant__ Args a) {
  constexpr int NW = T / 32;
  const NodeEnv& e = a.env;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, d = blockIdx.y, B = gridDim.x, D = a.D;
  const int off = d * a.NL + b * a.ROWS;
  const int end = min(off + a.ROWS, (d + 1) * a.NL);
  const float NEG_F = static_cast<float>(-1e30);

  // the task, from device memory
  const ShardTask<WIDE> t =
      load_shard_task<WIDE>(e, a.req, 1, a.task, 1, a.istgt[0] > 0);

  Cand c[2] = {{NEG_F, INT_MAX, 0}, {NEG_F, INT_MAX, 0}};
  int any = 0;  // bit v: some row is feasible in view v
  for (int i = off + tid; i < end; i += T) {
    const RowEval r = shard_row(e, a.rel, a.pip, t, i);
    const float score = r.score;
    const bool feas[2] = {r.now, r.fut};
    for (int v = 0; v < 2; ++v) {
      merge(c[v], feas[v] ? score : NEG_F, i, feas[v] ? 1 : 0);
      any |= feas[v] ? (1 << v) : 0;
    }
  }

  // block reduction of both views, to thread 0
  __shared__ float red_s[2][NW];
  __shared__ int red_i[2][NW], red_n[2][NW];
  __shared__ bool last;
  for (int v = 0; v < 2; ++v) {
    for (int o = 16; o > 0; o >>= 1) {
      const float s = __shfl_down_sync(0xffffffffu, c[v].s, o);
      const int i = __shfl_down_sync(0xffffffffu, c[v].i, o);
      const int n = __shfl_down_sync(0xffffffffu, c[v].n, o);
      merge(c[v], s, i, n);
    }
    if (lane == 0) {
      red_s[v][warp] = c[v].s;
      red_i[v][warp] = c[v].i;
      red_n[v][warp] = c[v].n;
    }
  }
  const int any_now = __syncthreads_or(any & 1);
  const int any_fut = __syncthreads_or(any & 2);
  if (warp == 0) {
    Part p;
    for (int v = 0; v < 2; ++v) {
      Cand w = {NEG_F, INT_MAX, 0};
      if (lane < NW) w = {red_s[v][lane], red_i[v][lane], red_n[v][lane]};
      for (int o = 16; o > 0; o >>= 1) {
        const float s = __shfl_down_sync(0xffffffffu, w.s, o);
        const int i = __shfl_down_sync(0xffffffffu, w.i, o);
        const int n = __shfl_down_sync(0xffffffffu, w.n, o);
        merge(w, s, i, n);
      }
      p.s[v] = w.s;
      p.i[v] = w.i;
      p.n[v] = w.n;
    }
    if (lane == 0) {
      p.any = (any_now ? 1 : 0) | (any_fut ? 2 : 0);
      p.pad = 0;
      a.part[d * B + b] = p;
      __threadfence();
      last = atomicAdd(a.ticket, 1u) == static_cast<unsigned>(D * B - 1);
    }
  }
  __syncthreads();
  if (!last) return;

  // the last block: warp w merges the partials of shards w, w + NW, ...
  // (lane l those of blocks l, l + 32, ..., then a shuffle tree; the merge
  // is exact and order-free, so this order gives the block order's bits)
  __threadfence();
  for (int dd = warp; dd < D; dd += NW) {
    Cand w[2] = {{NEG_F, INT_MAX, 0}, {NEG_F, INT_MAX, 0}};
    int found = 0;
    for (int bb = lane; bb < B; bb += 32) {
      const Part* p = a.part + dd * B + bb;
      for (int v = 0; v < 2; ++v)
        merge(w[v], __ldcg(&p->s[v]), __ldcg(&p->i[v]), __ldcg(&p->n[v]));
      found |= __ldcg(&p->any);
    }
    for (int v = 0; v < 2; ++v)
      for (int o = 16; o > 0; o >>= 1) {
        const float s = __shfl_down_sync(0xffffffffu, w[v].s, o);
        const int i = __shfl_down_sync(0xffffffffu, w[v].i, o);
        const int n = __shfl_down_sync(0xffffffffu, w[v].n, o);
        merge(w[v], s, i, n);
      }
    found = __reduce_or_sync(0xffffffffu, found);
    if (lane == 0)
      for (int v = 0; v < 2; ++v) {
        a.score_o[v * D + dd] = w[v].s;
        a.ints_o[(0 * 2 + v) * D + dd] = w[v].i;
        a.ints_o[(1 * 2 + v) * D + dd] = (found >> v) & 1;
        a.ints_o[(2 * 2 + v) * D + dd] = w[v].n;
      }
  }
  __syncthreads();
  // then the D shards, as shard_placer.combine: per view the winner (0 when
  // no row is feasible), whether any row is, the raw ties at the best
  if (tid < 2) {
    const int v = tid;
    const int* idx = a.ints_o + (0 * 2 + v) * D;
    const int* fnd = a.ints_o + (1 * 2 + v) * D;
    const int* tie = a.ints_o + (2 * 2 + v) * D;
    const float* sc = a.score_o + v * D;
    float gmax = fnd[0] > 0 ? sc[0] : NEG_F;
    bool found = false;
    for (int dd = 0; dd < D; ++dd) {
      const float msc = fnd[dd] > 0 ? sc[dd] : NEG_F;
      gmax = msc > gmax ? msc : gmax;
      found = found || fnd[dd] > 0;
    }
    int best = D * a.NL, ties = 0;
    for (int dd = 0; dd < D; ++dd) {
      const float msc = fnd[dd] > 0 ? sc[dd] : NEG_F;
      if (fnd[dd] > 0 && msc == gmax) {
        best = idx[dd] < best ? idx[dd] : best;
        ties += tie[dd];
      }
    }
    a.best_o[v] = found ? best : 0;
    a.best_o[2 + v] = ties;
    a.found_o[v] = found;
  }
  if (tid == 0) *a.ticket = 0u;
}

}  // namespace

// One launch over D shards of NL rows each, in blocks of ROWS rows of
// `threads` (128 or 256) threads. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int shard_candidates_launch(void* const* ptrs, const int* dims,
                                       const float* weights, void* stream) {
  const int D = dims[D_D], NL = dims[D_NL], R = dims[D_R], G = dims[D_G],
            T = dims[D_THREADS], ROWS = dims[D_ROWS];
  if (R < 1 || D < 1 || NL < 1 || G < 0 ||
      (T != 128 && T != 256) || ROWS < T || ROWS % T)
    return static_cast<int>(cudaErrorInvalidValue);
  auto F = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto FM = [&](int i) { return static_cast<float*>(ptrs[i]); };
  Args a = {};
  NodeEnv& e = a.env;
  e.tstat = F(P_TSTAT);
  e.tscore = F(P_TSCORE);
  e.nascore = F(P_NASCORE);
  e.blocknr = F(P_BLOCKNR);
  e.blockall = F(P_BLOCKALL);
  e.bonus = F(P_BONUS);
  e.locked = F(P_LOCKED);
  e.orfeas = F(P_ORFEAS);
  e.alloc = F(P_ALLOC);
  e.cnt = F(P_CNT);
  e.maxp = F(P_MAXP);
  e.gidle0 = F(P_GIDLE0);
  e.idle = FM(P_IDLE);
  e.pipe = FM(P_PIPE);
  e.pods = FM(P_PODS);
  e.gpux = FM(P_GPUX);
  e.N = D * NL;
  e.R = R;
  e.G = G;
  e.w_bin = weights[0];
  e.w_least = weights[1];
  e.w_most = weights[2];
  e.w_bal = weights[3];
  a.req = F(P_REQ);
  a.task = static_cast<const int*>(ptrs[P_TASK]);
  a.istgt = static_cast<const int*>(ptrs[P_ISTGT]);
  a.rel = F(P_REL);
  a.pip = F(P_PIP);
  a.score_o = FM(O_SCORE);
  a.ints_o = static_cast<int*>(ptrs[O_INTS]);
  a.best_o = static_cast<int*>(ptrs[O_BEST]);
  a.found_o = static_cast<bool*>(ptrs[O_FOUND]);
  a.part = static_cast<Part*>(ptrs[S_PART]);
  a.ticket = static_cast<unsigned int*>(ptrs[S_TICKET]);
  a.D = D;
  a.NL = NL;
  a.ROWS = ROWS;
  const dim3 grid((NL + ROWS - 1) / ROWS, D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = R > REG_R;
  if (T == 128 && !wide)
    shard_cand_kernel<128, false><<<grid, 128, 0, st>>>(a);
  else if (T == 128)
    shard_cand_kernel<128, true><<<grid, 128, 0, st>>>(a);
  else if (!wide)
    shard_cand_kernel<256, false><<<grid, 256, 0, st>>>(a);
  else
    shard_cand_kernel<256, true><<<grid, 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
