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
// Design (simple and right first):
// - Grid = D thread blocks, one per shard. Block d reads rows
//   [d * NL, (d + 1) * NL) of the global [.., N] tensors in place (row
//   stride N): no per-shard copies.
// - Each thread strides over the block's rows and keeps, per view, its best
//   (score, lowest row) and the feasible count at that score; one block
//   reduction (warp shuffles, then one warp over the warps' partials) merges
//   them: a higher score wins, equal scores keep the lower row and add
//   their counts. A row that is not feasible scores NEG = -1e30, so when no
//   row of the shard is feasible every row ties at NEG and the index is the
//   shard's first row, with a count of 0, as in the reference.
// - The task's scalars (request, GPU request, template, OR group, volume
//   pin, preferred node, revocable and target flags) are read from device
//   memory: the host never has to know them, so an attempt never waits.
// - A row's feasibility and score are placement.cuh's shard_row (shared
//   with kernel 5, csrc/shard_wave.cu, so both give the same bits for the
//   same row); the future view uses the scan association ((idle +
//   releasing) - pipelined) - pipe_extra, not the fused placers'
//   precomputed releasing - pipelined (they can differ by an ulp). Built
//   with --fmad=false and without fast math, as every kernel of the port.
//
// What bounds it: each launch reads about 21 float rows of N (0.86 MB at
// N = 10,240 with two resource dims), 0.26 us at 3.35 TB/s, and does a few
// hundred thousand float operations; the launch itself (a few us) and, at
// D = 1, one block walking 10,240 rows on one SM bound it. The cycle
// launches it once per attempt (about 100,000 times at the north star), so
// the host loop around it, not the kernel, sets the cycle's time. Spreading
// a shard over several blocks, or fusing the combine and the commit, is
// later work.

#include <climits>

#include "placement.cuh"

namespace {

using namespace placement;

// pointer slots of shard_candidates_launch: the inputs in the order of
// shard_placer.ShardArgs, then the outputs
enum Ptr {
  P_REQ, P_TASK, P_ISTGT, P_TSTAT, P_TSCORE, P_NASCORE, P_BLOCKNR,
  P_BLOCKALL, P_BONUS, P_LOCKED, P_ORFEAS, P_REL, P_PIP, P_ALLOC, P_CNT,
  P_MAXP, P_GIDLE0, P_IDLE, P_PIPE, P_PODS, P_GPUX,
  // outputs: scores f32[2, D], then (index, found, ties) i32[3, 2, D]
  O_SCORE, O_INTS,
  N_PTRS
};

// integer dimensions of shard_candidates_launch
enum Dim { D_D, D_NL, D_R, D_G, N_DIMS };

struct Args {
  NodeEnv env;          // alloc, cnt, maxp, gidle0, idle, pipe, pods, gpux
  const float* req;     // [1, R (+1)]
  const int* task;      // [1, 6]
  const int* istgt;     // [1, 1]
  const float* rel;     // [R, N]
  const float* pip;     // [R, N]
  float* score_o;
  int* ints_o;
  int D, NL;
};

__global__ void __launch_bounds__(BLOCK)
    shard_cand_kernel(const __grid_constant__ Args a) {
  const NodeEnv& e = a.env;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = blockIdx.x * a.NL, end = off + a.NL;
  const float NEG_F = static_cast<float>(-1e30);

  // the task, from device memory
  const ShardTask t = load_shard_task(e, a.req, a.task, 1, a.istgt[0] > 0);

  Cand c[2] = {{NEG_F, INT_MAX, 0}, {NEG_F, INT_MAX, 0}};
  int any = 0;  // bit v: some row is feasible in view v
  for (int i = off + tid; i < end; i += BLOCK) {
    const RowEval r = shard_row(e, a.rel, a.pip, t, i);
    const float score = r.score;
    const bool feas[2] = {r.now, r.fut};
    for (int v = 0; v < 2; ++v) {
      merge(c[v], feas[v] ? score : NEG_F, i, feas[v] ? 1 : 0);
      any |= feas[v] ? (1 << v) : 0;
    }
  }

  // block reduction of both views
  __shared__ float red_s[2][WARPS];
  __shared__ int red_i[2][WARPS], red_n[2][WARPS];
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
    for (int v = 0; v < 2; ++v) {
      Cand w = {red_s[v][lane], red_i[v][lane], red_n[v][lane]};
      for (int o = 16; o > 0; o >>= 1) {
        const float s = __shfl_down_sync(0xffffffffu, w.s, o);
        const int i = __shfl_down_sync(0xffffffffu, w.i, o);
        const int n = __shfl_down_sync(0xffffffffu, w.n, o);
        merge(w, s, i, n);
      }
      if (lane == 0) {
        const int d = blockIdx.x, D = a.D;
        a.score_o[v * D + d] = w.s;
        a.ints_o[(0 * 2 + v) * D + d] = w.i;
        a.ints_o[(1 * 2 + v) * D + d] = (v == 0 ? any_now : any_fut) ? 1 : 0;
        a.ints_o[(2 * 2 + v) * D + d] = w.n;
      }
    }
  }
}

}  // namespace

// One launch over D shards of NL rows each. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int shard_candidates_launch(void* const* ptrs, const int* dims,
                                       const float* weights, void* stream) {
  const int D = dims[D_D], NL = dims[D_NL], R = dims[D_R], G = dims[D_G];
  if (R < 1 || R > MAX_R || D < 1 || NL < 1 || G < 0)
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
  a.D = D;
  a.NL = NL;
  shard_cand_kernel<<<D, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
