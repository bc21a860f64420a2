// Wide shard-local candidate search: W placement attempts against one
// snapshot of each shard's rows, a top-C candidate list per attempt, and
// the D shards' lists combined.
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_place.py
// `_shard_wave_kernel` (built by `make_shard_wave_placer`), and the
// wavefront walk's cross-shard combine (volcano_tpu/ops/allocate_scan.py
// `_wave_combine`). The plain PyTorch version of the same function, the
// argument order, the combine and the wavefront walk that calls it are in
// volcano_tpu_torch/ops/shard_wave.py and ops/allocate_scan.py.
//
// The wavefront walk of the sharded allocate cycle (wave_width W > 1) asks,
// once a wave, each of the D shards of NL rows for the next W slots of the
// popped job: per slot (column) and capacity view ("now": fit on idle;
// "future": fit on future idle) the shard's top C feasible rows by (score
// desc, global row asc), the shard's feasible count and the raw count of
// feasible rows at its best score. Entries past the feasible count carry
// NEG = -1e30 and the shard's sentinel row off + NL, as in the reference.
// The walk reads the D lists combined: per column and view the global top
// C (row N and NEG past the entries), the counts summed, and the raw ties
// summed over the shards whose best is the global best.
//
// What bounds it: a launch reads each row's node fields once per column
// (0.86 MB at N = 10,240 for each of W columns, from L2 after the first)
// and does W times kernel 4's float operations; the bytes bound is
// 0.26 us, the operations bound smaller. One block a (column, shard)
// would put 8 of 132 SMs to work at D = 1, W = 8, each walking 10,240
// rows and then 2 x C block-wide rounds of two barriers each; and a
// combine in the walk costs a dozen small operations on the host a wave.
//
// Design: a split-row grid whose last block merges and combines (kernel
// 4's, csrc/shard_candidates.cu, with top-C lists in place of one pick).
// - Grid = B x W x D blocks of WB = 256 threads, a row a thread (kernel
//   4's default block), B = ceil(NL / WB). Block (b, w, d) takes the rows
//   [d * NL + b * WB, ...) of shard d, cut at the shard's end, for column
//   w. It reads the global [.., N] tensors in place and its task's
//   scalars from column w of the request [R (+1), W] and task [7, W]
//   tables on the card: the host never has to know them.
// - A row's feasibility and score are placement.cuh's shard_row, which
//   kernel 4 uses too: the same bits for the same row, which the walk's
//   exact rescore of touched rows relies on.
// - The block reads its column's task scalars once (a thread a scalar)
//   into shared memory: a load a thread would queue the grid's blocks on
//   the same few lines.
// - Each thread evaluates its row. Each warp sorts its entries of each
//   view (a bitonic network of shuffles; a row that is not feasible is an
//   empty entry, after every other), so its top C are its first lanes; a
//   ballot gives its feasible count and its raw ties at its best: a List.
// - One step merges up to GROUP = 8 Lists into one, a warp at a time
//   (merge_lists: the lists' entries, two a lane, odd lists reversed, so
//   only the last three stages of the bitonic network remain; the counts
//   summed, the ties summed over the lists whose best is the merged best).
//   Every merge of the kernel is that one function, not inlined: the
//   block's merge of its warps' lists, the last block's merges of the
//   partials and its combine of the shards, so the last block runs code
//   that the SM has just run.
// - Each block merges its warps' lists into its partial (a List a view)
//   in a scratch Part[W, D, B], makes it visible (__threadfence) and takes
//   a ticket from its column's counter (atomicAdd). The block that takes
//   the column's last ticket merges each shard's B partials in a tree of
//   such steps (groups of 8, all warps at once, the levels in shared
//   memory; past what a block's shared memory holds, about 2.9 M rows a
//   shard, in a scratch of device memory the wrapper keeps a column, the
//   same levels in the same order), writes the per-shard outputs in the
//   plain version's layout,
//   merges the D shards' lists the same way (the combine: with one shard
//   its list is the combined list), writes the combined outputs and puts
//   the counter back to 0 for the next launch.
// - Exact: (score desc, row asc) is a total order on the entries and the
//   counts are integers, so the bits do not depend on which block finishes
//   first or on how the lists are grouped. The walk needs no combine of
//   its own.
// - The counters and the scratch belong to one stream of one device (the
//   wrapper keeps a set for each): launches that share them run one after
//   another, as the walk's do. The output buffer's layout is the
//   wrapper's (shard_wave.output_layout): the launcher takes each field's
//   byte offset. Built with --fmad=false and without fast math, as every
//   kernel of the port.

#include <climits>

#include "placement.cuh"

namespace {

using namespace placement;

constexpr int MAX_C = 8;  // allocate_scan.wave_candidate_depth's cap
// lists a warp merges at once: 64 entries, two a lane
constexpr int GROUP = 64 / MAX_C;

// pointer slots of shard_wave_launch: the node-axis inputs in the order of
// shard_wave.WaveArgs (after req and task), then the scratch: the blocks'
// partials Part[W, D, B], the column counters u32[W] (0), and the last
// blocks' merge levels List[W, level_lists(D, B)] where they do not fit
// shared memory (else null)
enum Ptr {
  P_TSTAT, P_TSCORE, P_NASCORE, P_BLOCKNR, P_BLOCKALL, P_BONUS, P_LOCKED,
  P_ORFEAS, P_REL, P_PIP, P_ALLOC, P_CNT, P_MAXP, P_GIDLE0, P_IDLE, P_PIPE,
  P_PODS, P_GPUX,
  S_PART, S_TICKET, S_LEVELS,
  N_PTRS
};

// integer dimensions of shard_wave_launch: the wrapper's block count B and
// scratch bytes are checked against the kernel's own
enum Dim { D_D, D_NL, D_R, D_G, D_W, D_C, D_B, D_PART_BYTES, D_LEVEL_BYTES,
           N_DIMS };

// the output fields, in the order of shard_wave.WaveCandidates: the
// launcher takes each one's byte offset in the output buffer
enum Field {
  F_SCORE, F_IDX, F_COUNT, F_TIES, F_EIDX, F_ESCORE, F_EFOUND, F_ECOUNT,
  F_ETIES, N_FIELDS
};

constexpr int WB = 256;  // threads a block, a row each
constexpr int NW = WB / 32;
// the dynamic shared memory the last block's merge levels may take: a
// block's 232,448 bytes less 4,096 for the static lists
// (shard_wave.MAX_LEVEL_BYTES)
constexpr size_t MAX_LEVEL_SHARED = 232448 - 4096;

// the istgt row of the task table i32[7, W] (after shard_placer.TASK_FIELDS)
constexpr int T_ISTGT = 6;

// a top-C list: its first min(C, cnt) entries by `before` (the others are
// not read), its feasible count and the raw ties at its best (entry 0), 0
// when the count is 0
struct List {
  float s[MAX_C];
  int i[MAX_C];
  int cnt;
  int tie;
};

// one block's partial: a list a view
struct Part {
  List v[2];
};

struct Args {
  NodeEnv env;       // alloc, cnt, maxp, gidle0, idle, pipe, pods, gpux
  const float* req;  // [R (+1), W]
  const int* task;   // [7, W]
  const float* rel;  // [R, N]
  const float* pip;  // [R, N]
  float* score_o;    // [2, D * C, W]
  int* rows_o;       // [2, D * C, W]
  int* cnt_o;        // [2, D, W]
  int* ties_o;       // [2, D, W]
  int* ei_o;         // [2, W, C]
  float* ev_o;       // [2, W, C]
  bool* eo_o;        // [2, W, C]
  int* ecnt_o;       // [2, W]
  int* etie_o;       // [2, W]
  Part* part;
  unsigned int* ticket;
  List* levels;  // [W, level_lists(D, B)], or null: in shared memory
  int D, NL, W, C;
};

// the last block's two buffers of lists: level 1's 2 D ceil(B / GROUP),
// and level 2's 2 D ceil(B / GROUP^2), which also hold the levels after
// it (taken in turn) and the combine's
__host__ __device__ inline size_t level_lists(int D, int B) {
  const size_t g1 = (B + GROUP - 1) / GROUP;
  const size_t g2 = (g1 + GROUP - 1) / GROUP;
  return 2 * static_cast<size_t>(D) * (g1 + g2);
}

// the order of the entries: a higher score first, then a lower row
__device__ __forceinline__ bool before(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

// Sorts the warp's 32 x K entries by `before` (a bitonic network, from its
// stage FIRST on: the runs of FIRST / 2 entries must be sorted already,
// the even ones first to last, the odd ones last to first): entry
// e = 32 k + l is register k of lane l, and afterwards the entries are in
// order of e. Partners 32 or more apart are registers of one lane; the
// others swap through a shuffle.
template <int K, int FIRST>
__device__ __forceinline__ void warp_sort(float (&s)[K], int (&i)[K]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = FIRST; k <= 32 * K; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        // the pair's lower entry keeps the first of the two where bit k
        // of its index is clear, the later one where it is set
        const bool up = ((32 * r + lane) & k) == 0;
        if (j >= 32) {
          const int q = r ^ (j >> 5);
          if (q > r && (up ? before(s[q], i[q], s[r], i[r])
                           : before(s[r], i[r], s[q], i[q]))) {
            const float ts = s[r];
            const int ti = i[r];
            s[r] = s[q];
            i[r] = i[q];
            s[q] = ts;
            i[q] = ti;
          }
        } else {
          const float os = __shfl_xor_sync(0xffffffffu, s[r], j);
          const int oi = __shfl_xor_sync(0xffffffffu, i[r], j);
          const bool lower = (lane & j) == 0;
          if (lower == up ? before(os, oi, s[r], i[r])
                          : before(s[r], i[r], os, oi)) {
            s[r] = os;
            i[r] = oi;
          }
        }
      }
    }
  }
}

// Merges the n <= GROUP lists L[0], L[stride], ..., L[(n - 1) * stride]
// into *out (every lane of the warp calls it): their first C entries by
// `before`, the counts summed, and the raw ties summed over the lists
// whose best is the merged best. The lists are read through volatile: they
// may be partials that other blocks wrote (and made visible) during this
// launch, which the SM's L1 must not serve. Not inlined, so every merge of
// the kernel runs the same code.
__device__ __noinline__ void merge_lists(const volatile List* L, int stride,
                                         int n, int C, List* out) {
  const int lane = threadIdx.x & 31;
  const float lowest = __int_as_float(0xff800000);  // -inf
  // entry e = 32 r + lane is slot e % MAX_C of list e / MAX_C, the odd
  // lists' slots last to first: runs of MAX_C sorted for the network's
  // stage 2 * MAX_C; all loads are issued before any is used
  float s[2];
  int i[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = 32 * r + lane, l = e / MAX_C, p = e % MAX_C;
    const int c = l & 1 ? MAX_C - 1 - p : p;
    ok[r] = false;
    s[r] = lowest;
    i[r] = INT_MAX;
    if (l < n) {
      const volatile List* x = L + l * stride;
      ok[r] = c < min(C, x->cnt);
      s[r] = x->s[c];
      i[r] = x->i[c];
    }
  }
  int cnt = 0, tie = 0;
  float best_l = lowest;
  if (lane < n) {
    const volatile List* x = L + lane * stride;
    cnt = x->cnt;
    tie = x->tie;
    best_l = x->s[0];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) {
      s[r] = lowest;
      i[r] = INT_MAX;
    }
  }
  warp_sort<2, 2 * MAX_C>(s, i);
  const float best = __shfl_sync(0xffffffffu, s[0], 0);
  tie = __reduce_add_sync(0xffffffffu, cnt > 0 && best_l == best ? tie : 0);
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane < min(C, cnt)) {
    out->s[lane] = s[0];
    out->i[lane] = i[0];
  }
  if (lane == 0) {
    out->cnt = cnt;
    out->tie = cnt > 0 ? tie : 0;
  }
}

// One level of the last block's tree: the runs of n lists of the 2 x S
// (view v, run k) pairs, pair q = v * S + k, list j at src[v * vs + k * ks +
// j * js], merged in groups of GROUP into ng = ceil(n / GROUP) lists each,
// dst[q * ng + g], a warp a group. Returns ng.
__device__ __forceinline__ int merge_level(const volatile List* src, int vs,
                                           int ks, int js, int n, int S,
                                           int C, List* dst) {
  const int warp = threadIdx.x >> 5;
  const int ng = (n + GROUP - 1) / GROUP;
  for (int t = warp; t < 2 * S * ng; t += NW) {
    const int q = t / ng, g = t % ng;
    merge_lists(src + (q / S) * vs + (q % S) * ks + g * GROUP * js, js,
                min(GROUP, n - g * GROUP), C, dst + t);
  }
  __syncthreads();
  return ng;
}

// WIDE: built for R > REG_R resource dims (placement.cuh)
template <bool WIDE>
__global__ void __launch_bounds__(WB)
    shard_wave_kernel(const __grid_constant__ Args a) {
  const NodeEnv& e = a.env;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, w = blockIdx.y, d = blockIdx.z, B = gridDim.x;
  const int W = a.W, C = a.C, D = a.D, NL = a.NL;
  // this thread's row, if it lies in the shard
  const int i = d * NL + b * WB + tid;
  const bool inside = b * WB + tid < NL;
  const float NEG_F = static_cast<float>(-1e30);
  const float lowest = __int_as_float(0xff800000);  // -inf

  // column w's task, from device memory: one load a scalar for the block
  // (the launch's blocks all read the same few lines, so a load a thread
  // would queue on them), then every thread from shared memory; the WIDE
  // build reads the request where it uses it, from column w in place
  __shared__ float s_req[REG_R + 1];
  __shared__ int s_task[T_ISTGT + 1];
  if (!WIDE && tid <= a.env.R)
    s_req[tid] = tid < a.env.R || a.env.G > 0 ? a.req[tid * W + w] : 0.0f;
  if (tid >= 32 && tid <= 32 + T_ISTGT)
    s_task[tid - 32] = a.task[(tid - 32) * W + w];
  __syncthreads();
  const ShardTask<WIDE> t =
      WIDE ? load_shard_task<WIDE>(e, a.req + w, W, s_task, 1,
                                   s_task[T_ISTGT] > 0)
           : load_shard_task<WIDE>(e, s_req, 1, s_task, 1,
                                   s_task[T_ISTGT] > 0);

  // this thread's entry a view: its row if it is feasible there, else
  // nothing (-inf, INT_MAX)
  RowEval r = {false, false, 0.0f};
  if (inside) r = shard_row(e, a.rel, a.pip, t, i);
  float es[2][1] = {{r.now ? r.score : lowest}, {r.fut ? r.score : lowest}};
  int ei[2][1] = {{r.now ? i : INT_MAX}, {r.fut ? i : INT_MAX}};

  // each warp's entries sorted a view: its list (top C, feasible count,
  // raw ties at its best)
  __shared__ List wl[2][NW];
  __shared__ bool last;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int cnt = __popc(__ballot_sync(0xffffffffu, ei[v][0] != INT_MAX));
    warp_sort<1, 2>(es[v], ei[v]);
    const float best = __shfl_sync(0xffffffffu, es[v][0], 0);
    const int tie = __popc(__ballot_sync(
        0xffffffffu, ei[v][0] != INT_MAX && es[v][0] == best));
    if (lane < min(C, cnt)) {
      wl[v][warp].s[lane] = es[v][0];
      wl[v][warp].i[lane] = ei[v][0];
    }
    if (lane == 0) {
      wl[v][warp].cnt = cnt;
      wl[v][warp].tie = tie;
    }
  }
  __syncthreads();

  // warp v merges the warps' lists of view v: the block's partial
  Part* const parts = a.part + static_cast<size_t>(w) * D * B;
  if (warp < 2) {
    merge_lists(wl[warp], 1, NW, C, &parts[d * B + b].v[warp]);
    __threadfence();
  }
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(a.ticket + w, 1u) == static_cast<unsigned>(D * B - 1);
  __syncthreads();
  if (!last) return;

  // the last block of column w: each shard's B partials of each view
  // merged in a tree of levels (pair q = v * D + dd), into two buffers of
  // lists taken in turn: in shared memory, or in column w's part of the
  // levels scratch (read back through merge_lists' volatile loads, written
  // and read by this block alone, between its barriers)
  extern __shared__ List lv[];
  List* const base =
      a.levels != nullptr ? a.levels + static_cast<size_t>(w) * level_lists(D, B)
                          : lv;
  List* buf[2] = {base, base + 2 * D * ((B + GROUP - 1) / GROUP)};
  __threadfence();
  // level 1 from the partials (a Part is two lists: pair (v, dd)'s list j
  // is list 2 (dd B + j) + v from the column's first), then the levels in
  // shared memory (pair q's run of n lists at q n)
  int n = merge_level(parts[0].v, 1, 2 * B, 2, B, D, C, buf[0]), k = 0;
  while (n > 1) {
    n = merge_level(buf[k], D * n, n, 1, n, D, C, buf[k ^ 1]);
    k ^= 1;
  }
  // the shards' lists, pair q at buf[k][q]: the per-shard outputs
  const List* sl = buf[k];
  for (int x = tid; x < 2 * D * C; x += WB) {
    const int q = x / C, c = x % C, dd = q % D;
    const bool ok = c < min(C, sl[q].cnt);
    a.score_o[x * W + w] = ok ? sl[q].s[c] : NEG_F;
    a.rows_o[x * W + w] = ok ? sl[q].i[c] : (dd + 1) * NL;  // the sentinel
  }
  for (int q = tid; q < 2 * D; q += WB) {
    a.cnt_o[q * W + w] = sl[q].cnt;
    a.ties_o[q * W + w] = sl[q].tie;
  }

  // then the D > 1 shards, as shard_wave.combine: view v's D lists
  // merged by the same levels (one shard: its list is the combined list)
  n = D;
  while (n > 1) {
    n = merge_level(buf[k], n, 0, 1, n, 1, C, buf[k ^ 1]);
    k ^= 1;
  }
  const List* cl = buf[k];  // view v's combined list at cl[v]
  const int N = D * NL;
  for (int x = tid; x < 2 * C; x += WB) {
    const int v = x / C, c = x % C;
    const bool ok = c < min(C, cl[v].cnt);
    const int at = (v * W + w) * C + c;
    a.ei_o[at] = ok ? cl[v].i[c] : N;
    a.ev_o[at] = ok ? cl[v].s[c] : NEG_F;
    a.eo_o[at] = ok;
  }
  if (tid < 2) {
    a.ecnt_o[tid * W + w] = cl[tid].cnt;
    a.etie_o[tid * W + w] = cl[tid].tie;
  }
  if (tid == 0) a.ticket[w] = 0u;
}

size_t level_bytes(int D, int B) { return sizeof(List) * level_lists(D, B); }

}  // namespace

// One launch over D shards of NL rows and W columns: node-axis pointers
// and scratch `ptrs` (Ptr), dimensions `dims` (Dim), the byte offset of
// each output field in `out` (`at`, Field), the four score weights, the
// per-wave req and task, and the stream. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int shard_wave_launch(void* const* ptrs, const int* dims,
                                 const int* at, const float* weights,
                                 const void* req, const void* task, void* out,
                                 void* stream) {
  const int D = dims[D_D], NL = dims[D_NL], R = dims[D_R], G = dims[D_G];
  const int W = dims[D_W], C = dims[D_C];
  const int B = (NL + WB - 1) / WB;
  // the merge levels in shared memory where they fit, else in the scratch
  const size_t bytes = level_bytes(D, B);
  const bool in_shared = bytes <= MAX_LEVEL_SHARED;
  if (R < 1 || D < 1 || NL < 1 || G < 0 || W < 1 || C < 1 ||
      C > MAX_C || dims[D_B] != B ||
      static_cast<size_t>(dims[D_PART_BYTES]) <
          sizeof(Part) * static_cast<size_t>(B) * W * D ||
      (!in_shared && (ptrs[S_LEVELS] == nullptr ||
                      static_cast<size_t>(dims[D_LEVEL_BYTES]) <
                          bytes * static_cast<size_t>(W))))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = R > REG_R;
  const size_t smem = in_shared ? bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wide ? shard_wave_kernel<true> : shard_wave_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
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
  a.req = static_cast<const float*>(req);
  a.task = static_cast<const int*>(task);
  a.rel = F(P_REL);
  a.pip = F(P_PIP);
  char* o = static_cast<char*>(out);
  a.score_o = reinterpret_cast<float*>(o + at[F_SCORE]);
  a.rows_o = reinterpret_cast<int*>(o + at[F_IDX]);
  a.cnt_o = reinterpret_cast<int*>(o + at[F_COUNT]);
  a.ties_o = reinterpret_cast<int*>(o + at[F_TIES]);
  a.ei_o = reinterpret_cast<int*>(o + at[F_EIDX]);
  a.ev_o = reinterpret_cast<float*>(o + at[F_ESCORE]);
  a.eo_o = reinterpret_cast<bool*>(o + at[F_EFOUND]);
  a.ecnt_o = reinterpret_cast<int*>(o + at[F_ECOUNT]);
  a.etie_o = reinterpret_cast<int*>(o + at[F_ETIES]);
  a.part = static_cast<Part*>(ptrs[S_PART]);
  a.ticket = static_cast<unsigned int*>(ptrs[S_TICKET]);
  a.levels = in_shared ? nullptr : static_cast<List*>(ptrs[S_LEVELS]);
  a.D = D;
  a.NL = NL;
  a.W = W;
  a.C = C;
  const dim3 grid(B, W, D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    shard_wave_kernel<true><<<grid, WB, smem, st>>>(a);
  else
    shard_wave_kernel<false><<<grid, WB, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
