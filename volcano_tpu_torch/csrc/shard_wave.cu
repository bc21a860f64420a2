// Wide shard-local candidate search: W placement attempts against one
// snapshot of each shard's rows, a top-C candidate list per attempt.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_place.py
// `_shard_wave_kernel` (built by `make_shard_wave_placer`). The plain
// PyTorch version of the same function, the argument order, the
// cross-shard combine and the wavefront walk that calls it are in
// volcano_tpu_torch/ops/shard_wave.py and ops/allocate_scan.py.
//
// The wavefront walk of the sharded allocate cycle (wave_width W > 1) asks,
// once a wave, each of the D shards of NL rows for the next W slots of the
// popped job: per slot (column) and capacity view ("now": fit on idle;
// "future": fit on future idle) the shard's top C feasible rows by (score
// desc, global row asc), the shard's feasible count and the raw count of
// feasible rows at its best score. Entries past the feasible count carry
// NEG = -1e30 and the shard's sentinel row off + NL, as in the reference.
//
// Design (simple and right first):
// - Grid = W x D thread blocks, one per (column, shard). Block (w, d) reads
//   rows [d * NL, (d + 1) * NL) of the global [.., N] tensors in place and
//   its task's scalars from column w of the request [R (+1), W] and task
//   [7, W] tables, on the card: the host never has to know them.
// - A row's feasibility and score are placement.cuh's shard_row, which
//   kernel 4 (csrc/shard_candidates.cu) uses too: the same bits for the
//   same row, which the walk's exact rescore of touched rows relies on.
// - Each thread strides over the block's rows and keeps, per view, its
//   own top MAX_C = 8 feasible (score, row) pairs in registers (an
//   unrolled insertion, so no local memory), its feasible count, and its
//   best score with the count at it (kernel 4's merge). One block
//   reduction sums the counts and merges the ties; then C rounds of a
//   block-wide (max score, min row) over the threads' list heads pick the
//   entries, and the winning thread pops its head. Every one of the
//   block's top C rows is in its own thread's top C, so the rounds are
//   exact. Both views share each round's two barriers.
// - 512 threads a block, so the two lists fit in registers; built with
//   --fmad=false and without fast math, as every kernel of the port.
//
// What bounds it: a launch reads each row's node fields once per column
// (the same 0.86 MB at N = 10,240 as kernel 4 for each of W columns, from
// L2 after the first) and does W times kernel 4's float operations; the
// bytes bound is 0.26 us, the operations bound smaller. At D = 1 only W
// blocks run, each one SM walking 10,240 rows (20 a thread) and then 2 x C
// block reductions, so it takes about what kernel 4 takes plus the
// rounds. The walk launches it once a wave.

#include <climits>

#include "placement.cuh"

namespace {

using namespace placement;

constexpr int WB = 512;  // threads a block
constexpr int WWARPS = WB / 32;
constexpr int MAX_C = 8;  // allocate_scan.wave_candidate_depth's cap

// pointer slots of shard_wave_launch: the inputs in the order of
// shard_wave.WaveArgs, then the outputs
enum Ptr {
  P_REQ, P_TASK, P_TSTAT, P_TSCORE, P_NASCORE, P_BLOCKNR, P_BLOCKALL,
  P_BONUS, P_LOCKED, P_ORFEAS, P_REL, P_PIP, P_ALLOC, P_CNT, P_MAXP,
  P_GIDLE0, P_IDLE, P_PIPE, P_PODS, P_GPUX,
  // outputs: scores f32[2, D * C, W], rows i32[2, D * C, W], counts and
  // raw ties i32[2, D, W]
  O_SCORE, O_ROWS, O_CNT, O_TIES,
  N_PTRS
};

// integer dimensions of shard_wave_launch
enum Dim { D_D, D_NL, D_R, D_G, D_W, D_C, N_DIMS };

// the istgt row of the task table i32[7, W] (after shard_placer.TASK_FIELDS)
constexpr int T_ISTGT = 6;

struct Args {
  NodeEnv env;       // alloc, cnt, maxp, gidle0, idle, pipe, pods, gpux
  const float* req;  // [R (+1), W]
  const int* task;   // [7, W]
  const float* rel;  // [R, N]
  const float* pip;  // [R, N]
  float* score_o;
  int* rows_o;
  int* cnt_o;
  int* ties_o;
  int D, NL, W, C;
};

// a thread's best feasible rows, (score desc, row asc); empty slots hold
// (-inf, INT_MAX), which every feasible row beats
struct TopC {
  float s[MAX_C];
  int i[MAX_C];
};

__device__ __forceinline__ bool before(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

__device__ __forceinline__ void push(TopC& t, float s, int i) {
#pragma unroll
  for (int k = 0; k < MAX_C; ++k) {
    if (before(s, i, t.s[k], t.i[k])) {
      const float ts = t.s[k];
      const int ti = t.i[k];
      t.s[k] = s;
      t.i[k] = i;
      s = ts;
      i = ti;
    }
  }
}

__device__ __forceinline__ void pop(TopC& t, float lowest) {
#pragma unroll
  for (int k = 0; k + 1 < MAX_C; ++k) {
    t.s[k] = t.s[k + 1];
    t.i[k] = t.i[k + 1];
  }
  t.s[MAX_C - 1] = lowest;
  t.i[MAX_C - 1] = INT_MAX;
}

__global__ void __launch_bounds__(WB)
    shard_wave_kernel(const __grid_constant__ Args a) {
  const NodeEnv& e = a.env;
  const int w = blockIdx.x, d = blockIdx.y;
  const int W = a.W, C = a.C, D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = d * a.NL, end = off + a.NL;
  const float NEG_F = static_cast<float>(-1e30);
  const float lowest = __int_as_float(0xff800000);  // -inf

  // column w's task, from device memory
  const ShardTask t = load_shard_task(e, a.req + w, a.task + w, W,
                                      a.task[T_ISTGT * W + w] > 0);

  TopC top[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int k = 0; k < MAX_C; ++k) {
      top[v].s[k] = lowest;
      top[v].i[k] = INT_MAX;
    }
  }
  Cand best[2] = {{NEG_F, INT_MAX, 0}, {NEG_F, INT_MAX, 0}};
  int nfeas[2] = {0, 0};
  for (int i = off + tid; i < end; i += WB) {
    const RowEval r = shard_row(e, a.rel, a.pip, t, i);
    const bool feas[2] = {r.now, r.fut};
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      merge(best[v], feas[v] ? r.score : NEG_F, i, feas[v] ? 1 : 0);
      if (feas[v]) {
        push(top[v], r.score, i);
        ++nfeas[v];
      }
    }
  }

  // the block's feasible counts and raw ties at its best
  __shared__ float red_s[2][WWARPS];
  __shared__ int red_i[2][WWARPS], red_n[2][WWARPS], red_c[2][WWARPS];
  __shared__ float win_s[2];
  __shared__ int win_i[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    for (int o = 16; o > 0; o >>= 1) {
      const float s = __shfl_down_sync(0xffffffffu, best[v].s, o);
      const int i = __shfl_down_sync(0xffffffffu, best[v].i, o);
      const int n = __shfl_down_sync(0xffffffffu, best[v].n, o);
      merge(best[v], s, i, n);
      nfeas[v] += __shfl_down_sync(0xffffffffu, nfeas[v], o);
    }
    if (lane == 0) {
      red_s[v][warp] = best[v].s;
      red_i[v][warp] = best[v].i;
      red_n[v][warp] = best[v].n;
      red_c[v][warp] = nfeas[v];
    }
  }
  __syncthreads();
  if (warp < 2) {
    const int v = warp;
    Cand b = {NEG_F, INT_MAX, 0};
    int cnt = 0;
    if (lane < WWARPS) {
      b = {red_s[v][lane], red_i[v][lane], red_n[v][lane]};
      cnt = red_c[v][lane];
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float s = __shfl_down_sync(0xffffffffu, b.s, o);
      const int i = __shfl_down_sync(0xffffffffu, b.i, o);
      const int n = __shfl_down_sync(0xffffffffu, b.n, o);
      merge(b, s, i, n);
      cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    }
    if (lane == 0) {
      a.cnt_o[(v * D + d) * W + w] = cnt;
      a.ties_o[(v * D + d) * W + w] = b.n;
    }
  }
  __syncthreads();  // the rounds below reuse red_s and red_i

  // C rounds: the block's best remaining (score, row) of each view
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      float bs = top[v].s[0];
      int bi = top[v].i[0];
      for (int o = 16; o > 0; o >>= 1) {
        const float s = __shfl_down_sync(0xffffffffu, bs, o);
        const int i = __shfl_down_sync(0xffffffffu, bi, o);
        if (before(s, i, bs, bi)) {
          bs = s;
          bi = i;
        }
      }
      if (lane == 0) {
        red_s[v][warp] = bs;
        red_i[v][warp] = bi;
      }
    }
    __syncthreads();
    if (warp < 2) {
      const int v = warp;
      float bs = lowest;
      int bi = INT_MAX;
      if (lane < WWARPS) {
        bs = red_s[v][lane];
        bi = red_i[v][lane];
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float s = __shfl_down_sync(0xffffffffu, bs, o);
        const int i = __shfl_down_sync(0xffffffffu, bi, o);
        if (before(s, i, bs, bi)) {
          bs = s;
          bi = i;
        }
      }
      if (lane == 0) {
        win_s[v] = bs;
        win_i[v] = bi;
        const bool hit = bs > lowest;  // an entry within the count
        const size_t k = (static_cast<size_t>(v * D + d) * C + c) * W + w;
        a.score_o[k] = hit ? bs : NEG_F;
        a.rows_o[k] = hit ? bi : end;
      }
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < 2; ++v)
      if (win_s[v] > lowest && top[v].i[0] == win_i[v]) pop(top[v], lowest);
  }
}

}  // namespace

// One launch over D shards of NL rows and W columns. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int shard_wave_launch(void* const* ptrs, const int* dims,
                                 const float* weights, void* stream) {
  const int D = dims[D_D], NL = dims[D_NL], R = dims[D_R], G = dims[D_G];
  const int W = dims[D_W], C = dims[D_C];
  if (R < 1 || R > MAX_R || D < 1 || NL < 1 || G < 0 || W < 1 || C < 1 ||
      C > MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  auto F = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  auto FM = [&](int i) { return static_cast<float*>(ptrs[i]); };
  auto IM = [&](int i) { return static_cast<int*>(ptrs[i]); };
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
  a.rel = F(P_REL);
  a.pip = F(P_PIP);
  a.score_o = FM(O_SCORE);
  a.rows_o = IM(O_ROWS);
  a.cnt_o = IM(O_CNT);
  a.ties_o = IM(O_TIES);
  a.D = D;
  a.NL = NL;
  a.W = W;
  a.C = C;
  shard_wave_kernel<<<dim3(W, D), WB, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
