// Segmented sum in row order: out[s, d] is the float32 sum of vals[a, d]
// over the rows a with seg[a] == s, added one after another from +0 in row
// order. Rows whose segment lies outside [0, num) are dropped.
//
// The device version of the reference's masked segment sums in
// volcano_tpu/ops/fairshare.py: the drf namespace allocations of
// `namespace_shares` (a sum over the jobs) and the hdrf tree's subtree sums
// in `hdrf_tree_state`, which XLA computes with `segment_sum` in an order
// of its own choosing. The port fixes the order to row order, so this
// kernel, the plain version (volcano_tpu_torch/ops/seg_fold.py) and the
// namespace fold inside dyn_placer.cu give the same bits at any size.
//
// What bounds it: the chain of dependent float adds of a (segment, dim)
// pair, one add a term (about 4 cycles each), not the bytes (48 KB at
// check B's 4,096 jobs of 2 dims) or the arithmetic rate. One thread a
// pair running a chain over every row, each link a load from L2 or device
// memory, takes about 0.1 ms at check B, where every job lies in one
// namespace: the chain need only run over the terms, from shared memory.
//
// Design: a block of 8 warps takes a run of the (segment, dim) pairs, a
// warp a pair at a time: one block where num x D is at most the warps of a
// block, more (up to two an SM) only where it is larger (the hdrf tree),
// and more again where a block's run would outgrow its shared memory (past
// about 21,000 pairs a block at 2 dims); each block reads the rows once,
// tile by tile, for all its pairs, and keeps their sums in shared memory.
// A block's tile holds at most 42 dims (MAX_D: a tile of 256 rows still
// fits), so wider rows fold in chunks of dims, balanced, each a row of the
// grid (blockIdx.y; the CHUNKED build, so rows of at most 42 dims run the
// one-chunk code unchanged): a pair's terms, their order and its sum are
// its own, so the chunks give the bits of one block over all dims.
// - The block copies tiles of seg and vals into shared memory with
//   cp.async, coalesced, the next tile in flight while the warps work on
//   this one (two buffers).
// - The block lists the tile's live rows once for all its pairs: the rows
//   whose segment lies in [0, num) and whose value is not an exact zero in
//   some dim, in row order (a ballot a run of 32 rows, the warps' counts
//   summed in shared memory).
// - A warp lists its pair's terms among the live rows in row order: a
//   ballot a run of 32 (four at once), of the rows of its segment whose
//   value is not an exact zero, each such lane writing its value at the
//   list's end plus the popcount of the lanes below it.
// - Lane 0 then folds the list into the pair's sum, one add after
//   another, with the next eight terms' loads issued ahead of the adds.
// - Skipping exact zeros changes no bit: the sum starts at +0 and becomes
//   -0 only by adding -0 to -0, so it is never -0, and adding +0 or -0 to
//   anything but -0 leaves it as it was. A NaN or an infinity is not a
//   zero and is added. Rows of other segments and dropped rows never
//   match a pair's segment.
// Built with --fmad=false and without fast math, as every kernel of the
// port.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_TILE = 1024;  // rows a tile
// the dynamic shared memory a block may take (the attribute is set once)
constexpr int MAX_SHARED = 96 * 1024;
// a list holds a tile's terms and eight words past them, which the fold's
// look-ahead may read
constexpr int PAD = 8;
// runs of 32 rows a warp scans at once
constexpr int SCAN = 4;
// runs of 32 rows a warp marks live in a tile of MAX_TILE rows
constexpr int RUNS = MAX_TILE / BLOCK;

// dynamic shared memory of a tile of `tile` rows: the warps' lists, the
// live rows, and two buffers of seg and of vals
size_t shared_bytes(int tile, int D, int per) {
  return 4 * (static_cast<size_t>(WARPS) * (tile + PAD) + per + tile +
              2 * static_cast<size_t>(tile) * (1 + D));
}

__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// rows [t0, t0 + rows) of seg and of the chunk's dims [d0, d0 + dc) of
// vals (rows of D dims) into the tile buffers
template <bool CHUNKED>
__device__ __forceinline__ void load_tile(int* seg_t, float* val_t,
                                          const int* seg, const float* vals,
                                          int t0, int rows, int D, int d0,
                                          int dc) {
  for (int r = threadIdx.x; r < rows; r += BLOCK)
    copy4(seg_t + r, seg + t0 + r);
  const float* src = vals + static_cast<size_t>(t0) * D;
  if constexpr (!CHUNKED) {
    for (int k = threadIdx.x; k < rows * D; k += BLOCK)
      copy4(val_t + k, src + k);
  } else {
    for (int k = threadIdx.x; k < rows * dc; k += BLOCK)
      copy4(val_t + k, src + static_cast<size_t>(k / dc) * D + d0 + k % dc);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc plus L[0], L[1], ..., L[n - 1], one add after another; L is 16-byte
// aligned and readable for n + PAD words
__device__ __forceinline__ float fold(const float* L, int n, float acc) {
  const float4* L4 = reinterpret_cast<const float4*>(L);
  float4 a0 = L4[0], a1 = L4[1];
  int k = 0;
  for (; k + 8 <= n; k += 8) {
    const float4 b0 = L4[(k >> 2) + 2], b1 = L4[(k >> 2) + 3];
    acc = acc + a0.x;
    acc = acc + a0.y;
    acc = acc + a0.z;
    acc = acc + a0.w;
    acc = acc + a1.x;
    acc = acc + a1.y;
    acc = acc + a1.z;
    acc = acc + a1.w;
    a0 = b0;
    a1 = b1;
  }
  for (; k < n; ++k) acc = acc + L[k];
  return acc;
}

// vals [A, D]; CHUNKED: grid row y folds the dims [y * DC, y * DC + dc),
// dc = min(DC, D - y * DC), else the one row folds all D; the row's pairs
// p = s * dc + d, `per` a block
template <bool CHUNKED>
__global__ void __launch_bounds__(BLOCK)
    seg_fold_kernel(const float* __restrict__ vals,
                    const int* __restrict__ seg, int A, int D, int DC,
                    int num, int tile, int per, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  // a list a warp, the pairs' sums, the tile's live rows, then two tile
  // buffers of seg and of vals
  float* lists = smem;                           // [WARPS][tile + PAD]
  float* accs = lists + WARPS * (tile + PAD);    // [per]
  int* live = reinterpret_cast<int*>(accs + per);             // [tile]
  int* seg_t = live + tile;                                   // [2][tile]
  float* val_t = reinterpret_cast<float*>(seg_t + 2 * tile);  // [2][tile*D]
  __shared__ int wsum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  // this block's chunk of dims, and its pairs [p0, p0 + np) of the chunk
  const int d0 = CHUNKED ? blockIdx.y * DC : 0;
  const int dc = CHUNKED ? min(DC, D - d0) : D;
  const int p0 = blockIdx.x * per, np = min(per, num * dc - p0);
  if (CHUNKED && np <= 0) return;  // past a narrower last chunk's pairs
  const int tiles = (A + tile - 1) / tile;
  const int span = tile / WARPS;  // rows a warp marks, a multiple of 32
  float* L = lists + warp * (tile + PAD);
  for (int j = threadIdx.x; j < np; j += BLOCK) accs[j] = 0.0f;
  if (tiles > 0)
    load_tile<CHUNKED>(seg_t, val_t, seg, vals, 0, min(tile, A), D, d0, dc);
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles) {
      const int t1 = (t + 1) * tile;
      load_tile<CHUNKED>(seg_t + (cur ^ 1) * tile,
                val_t + static_cast<size_t>(cur ^ 1) * tile * dc, seg, vals,
                t1, min(tile, A - t1), D, d0, dc);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int* sg = seg_t + cur * tile;
    const float* vt = val_t + static_cast<size_t>(cur) * tile * dc;
    const int rows = min(tile, A - t * tile);

    // the tile's live rows in row order, once for all the block's pairs: a
    // segment in [0, num) and a value that is not an exact zero in some
    // dim (no other row adds to any pair's sum)
    unsigned lm[RUNS];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < RUNS; ++k) {
      const int r = warp * span + 32 * k + lane;
      bool ok = false;
      if (32 * k < span && r < rows) {
        ok = sg[r] >= 0 && sg[r] < num;
        bool nz = false;
        for (int dd = 0; dd < dc; ++dd) nz = nz || vt[r * dc + dd] != 0.0f;
        ok = ok && nz;
      }
      lm[k] = __ballot_sync(0xffffffffu, ok);
      cnt += __popc(lm[k]);
    }
    if (lane == 0) wsum[warp] = cnt;
    __syncthreads();
    int at = 0, nlive = 0;
    for (int k = 0; k < WARPS; ++k) {
      at += k < warp ? wsum[k] : 0;
      nlive += wsum[k];
    }
#pragma unroll
    for (int k = 0; k < RUNS; ++k) {
      if ((lm[k] >> lane) & 1u)
        live[at + __popc(lm[k] & below)] = warp * span + 32 * k + lane;
      at += __popc(lm[k]);
    }
    __syncthreads();

    // each warp its pairs j, j + WARPS, ...: the pair's terms among the
    // live rows, listed in row order, then folded into its sum
    for (int j = warp; j < np; j += WARPS) {
      const int s = (p0 + j) / dc, d = (p0 + j) % dc;
      int n = 0;
      for (int k0 = 0; k0 < nlive; k0 += 32 * SCAN) {
        // SCAN runs of 32 live rows at once: their loads and ballots are
        // independent, only the list's end carries from one to the next
        float v[SCAN];
        unsigned m[SCAN];
#pragma unroll
        for (int k = 0; k < SCAN; ++k) {
          const int q = k0 + 32 * k + lane;
          const int r = q < nlive ? live[q] : 0;
          const float x = vt[r * dc + d];
          v[k] = q < nlive && sg[r] == s ? x : 0.0f;
          m[k] = __ballot_sync(0xffffffffu, v[k] != 0.0f);
        }
#pragma unroll
        for (int k = 0; k < SCAN; ++k) {
          if (v[k] != 0.0f) L[n + __popc(m[k] & below)] = v[k];
          n += __popc(m[k]);
        }
      }
      __syncwarp();
      if (lane == 0) accs[j] = fold(L, n, accs[j]);
      __syncwarp();
    }
    __syncthreads();  // the buffers are written again
  }
  for (int j = threadIdx.x; j < np; j += BLOCK) {
    if constexpr (CHUNKED) {
      const int s = (p0 + j) / dc, d = (p0 + j) % dc;
      out[static_cast<size_t>(s) * D + d0 + d] = accs[j];
    } else {
      out[p0 + j] = accs[j];
    }
  }
}

// rows a tile for D dims and `per` pairs a block: the most, up to
// MAX_TILE, whose buffers fit; a multiple of the block's threads, so every
// warp marks whole runs of 32
int tile_rows(int D, int per) {
  for (int tile = MAX_TILE; tile >= BLOCK; tile >>= 1) {
    if (shared_bytes(tile, D, per) <= MAX_SHARED) return tile;
  }
  return 0;
}

// the most dims a block's tile holds: a tile of BLOCK rows and a block's
// first WARPS pairs fit
constexpr int MAX_D = 42;
static_assert(4 * (WARPS * (BLOCK + PAD) + WARPS + BLOCK +
                   2 * BLOCK * (1 + MAX_D)) <= MAX_SHARED &&
              4 * (WARPS * (BLOCK + PAD) + WARPS + BLOCK +
                   2 * BLOCK * (2 + MAX_D)) > MAX_SHARED,
              "MAX_D is the most dims a block's buffers hold");

// the most pairs a block keeps beside a tile of BLOCK rows of D dims
int max_per(int D) {
  return MAX_SHARED / 4 - WARPS * (BLOCK + PAD) - BLOCK - 2 * BLOCK * (1 + D);
}

}  // namespace

// vals f32[A, D], seg i32[A] (row-major, on the device); out f32[num, D].
// Takes num x D < 2^31 pairs, any D, in chunks of at most MAX_D dims.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int seg_fold_launch(const float* vals, const int* seg, int A,
                               int D, int num, float* out, void* stream) {
  // per device, once: its SM count, and the kernel's shared-memory limit
  static int sm_count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int& sms = sm_count[dev];
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(seg_fold_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MAX_SHARED);
    cudaFuncSetAttribute(seg_fold_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MAX_SHARED);
  }
  if (A < 0 || D < 0 || num < 0 ||
      static_cast<long long>(num) * D > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(num) * D == 0)
    return static_cast<int>(cudaGetLastError());
  // the dims in the fewest chunks of at most MAX_D, balanced: DC the widest
  const int chunks = (D + MAX_D - 1) / MAX_D;
  const int DC = (D + chunks - 1) / chunks;
  const long long P = static_cast<long long>(num) * DC;
  // a block a WARPS pairs of a chunk, up to two blocks an SM; then `per` a
  // block, but no more than a block keeps beside a tile (more blocks then)
  const long long want = (P + WARPS - 1) / WARPS;
  long long blocks = want < 2 * sms ? want : 2 * sms;
  const long long cap = max_per(DC);
  const int per = static_cast<int>(
      std::min((P + blocks - 1) / blocks, cap));
  blocks = (P + per - 1) / per;
  const int tile = tile_rows(DC, per);
  const int bytes = static_cast<int>(shared_bytes(tile, DC, per));
  const dim3 grid(static_cast<unsigned>(blocks), chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks > 1)
    seg_fold_kernel<true><<<grid, BLOCK, bytes, st>>>(vals, seg, A, D, DC,
                                                      num, tile, per, out);
  else
    seg_fold_kernel<false><<<grid, BLOCK, bytes, st>>>(vals, seg, A, D, DC,
                                                       num, tile, per, out);
  return static_cast<int>(cudaGetLastError());
}
