"""volcano_tpu_torch — the batch-scheduling framework on PyTorch and CUDA.

The port of ``volcano_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (``sm_90a``). It imports neither JAX nor the JAX
package: the pure-Python modules it shares with it are copies. Given the
same packed snapshot it returns the same decisions as the JAX package, bit
for bit.

Layering:

- ``volcano_tpu_torch.api``       — in-memory data model (a copy of
                                    ``volcano_tpu.api``).
- ``volcano_tpu_torch.arrays``    — dense array schema, the Python packer and
                                    ``to_device``.
- ``volcano_tpu_torch.ops``       — plain functions on tensors: predicates,
                                    scores, selection, fair shares, the
                                    allocate cycle, and the two placers with
                                    their CUDA kernels
                                    (``csrc/round_placer.cu``,
                                    ``csrc/dyn_placer.cu``, sharing
                                    ``csrc/placement.cuh``).
- ``volcano_tpu_torch.parallel``  — the node mesh and the sharded allocate
                                    cycle (the shard-local candidate
                                    kernel, ``csrc/shard_candidates.cu``).
- ``volcano_tpu_torch.plugins``   — policy plugins contributing weights and keys.
- ``volcano_tpu_torch.framework`` — conf, host-side extras and the Session.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"
