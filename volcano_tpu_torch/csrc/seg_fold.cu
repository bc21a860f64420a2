// Segmented sum in row order: out[s, d] is the float32 sum of vals[a, d]
// over the rows a with seg[a] == s, added one after another from 0 in row
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
// Design: one thread per output element (segment, dim), each a serial
// chain of A float adds. Every row is loaded and a row of another segment
// adds 0.0f, which leaves the sum's bits as they were (the sum starts at
// +0 and never becomes -0), so the loads carry no branch and the unrolled
// loop issues them ahead of the chain. What bounds it: the chain of A
// dependent adds per thread (A is thousands: jobs or tree nodes), not bytes
// or arithmetic rate.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void seg_fold_kernel(const float* __restrict__ vals,
                                const int* __restrict__ seg, int A, int D,
                                int num, float* __restrict__ out) {
  const int t = blockIdx.x * BLOCK + threadIdx.x;
  if (t >= num * D) return;
  const int s = t / D, d = t % D;
  float acc = 0.0f;
#pragma unroll 8
  for (int a = 0; a < A; ++a) {
    const float v = vals[static_cast<size_t>(a) * D + d];
    acc = acc + (seg[a] == s ? v : 0.0f);
  }
  out[t] = acc;
}

}  // namespace

// vals f32[A, D], seg i32[A] (row-major, on the device); out f32[num, D].
// Returns the CUDA error code of the launch (0 on success).
extern "C" int seg_fold_launch(const float* vals, const int* seg, int A,
                               int D, int num, float* out, void* stream) {
  const int n = num * D;
  if (n > 0)
    seg_fold_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(vals, seg, A, D,
                                                           num, out);
  return static_cast<int>(cudaGetLastError());
}
