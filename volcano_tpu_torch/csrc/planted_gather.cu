// Kernel 6 of the reference: the Pallas body of graphcheck's planted
// shard-local launch, `planted_gather_pallas` in
// volcano_tpu/analysis/sharding.py:149-181 (body `o_ref[:] = x_ref[:] * 2.0`,
// :165-166; the pallas_call at :170). Each shard of the reference's mesh
// all-gathers the node-sharded f32 [n_nodes, cols] input and doubles the
// whole gathered block in one launch: the deliberate fault the sharding
// audit must flag, a launch that reads the full node axis instead of its
// NL rows. The wrapper (volcano_tpu_torch/analysis/sharding.py) does the
// gather and the slice and records the launch's block.
//
// Design: one thread an element, o = x * 2.0f, exact in float32 (the
// plain version's `x * 2.0` gives the same bits). What bounds it: the
// bytes, 8 an element (one float read, one written); at the shapes it
// runs (a few ten thousand elements) a launch is launch latency.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void planted_double_kernel(const float* __restrict__ x,
                                      float* __restrict__ o, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}

}  // namespace

// x, o f32[n] (contiguous, on the device). Returns the CUDA error code of
// the launch (0 on success).
extern "C" int planted_double_launch(const float* x, float* o, int n,
                                     void* stream) {
  if (n > 0)
    planted_double_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return static_cast<int>(cudaGetLastError());
}
