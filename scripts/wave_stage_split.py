"""Where a launch of kernel 5 (the wide candidate search) spends its time.

    python3 scripts/wave_stage_split.py [--out PATH]

Builds a copy of ``volcano_tpu_torch/csrc/shard_wave.cu`` with a stamp of
the card's global timer (ns) written by thread 0 of every block at each
stage boundary (the source itself is unchanged; the copy goes to the
git-ignored ``volcano_tpu_torch/_build/``), launches it through the
wrapper on check I's first launch (``chip_smoke.py`` phase 20: one shard
of 10,240 rows, 8 columns) and on the same arguments cut into 4 shards of
2,560, checks its outputs against the plain version and the combine, and
reports per launch:

- the median and the largest over the blocks of each stage: ``task``
  (the column's task scalars), ``rows`` (the rows' feasibility and
  score), ``warp_sort`` (each warp's sort, to the block barrier),
  ``block_sort`` (the warps' lists sorted, the partial written and made
  visible), ``ticket``;
- the spread of the blocks' ends (ns after the first block's start);
- each column's last block: when it took the last ticket, its first
  level of merges (of the partials, read from L2), all the shards'
  levels, and the combine;
- the same for a launch right after another (``warm``).

Needs a CUDA card and ``nvcc``; prints the card's name and power limit and
one JSON object, which it also writes to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: the stamps, in order, each inserted before its anchor in the source
STAMPS = (
    ("start", "  // column w's task, from device memory"),
    ("task", "  // this thread's entry a view"),
    ("rows", "  // each warp's entries sorted a view"),
    ("warp_sort", "  // warp v merges the warps' lists of view v"),
    ("block_sort",
     "  __syncthreads();\n  if (tid == 0)\n    last = atomicAdd"),
)
#: slots of the non-last blocks' end, and the last block's stamps
END, LAST, LEVEL1, MERGED, DONE = 5, 6, 7, 8, 9
SLOTS = 16
MAX_BLOCKS = 4096

HEAD = f"""
__device__ unsigned long long g_stamp[{MAX_BLOCKS} * {SLOTS}];
#define STAMP(k) do {{ if (threadIdx.x == 0) {{ \\
  unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  g_stamp[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + \\
           blockIdx.x) * {SLOTS} + (k)] = t_; }} }} while (0)
"""
TAIL = f"""
extern "C" int read_stamps(unsigned long long* host) {{
  cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
  return (int)cudaDeviceSynchronize();
}}
"""


def instrumented_source(src: str) -> str:
    """The kernel's source with the stamps inserted."""
    def insert(text, anchor, code):
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in shard_wave.cu: "
                             f"{anchor!r}")
        return text.replace(anchor, code + anchor)
    src = insert(src, "namespace {\n", HEAD)
    for k, (_, anchor) in enumerate(STAMPS):
        src = insert(src, anchor, f"  STAMP({k});\n")
    src = src.replace(
        "  if (!last) return;\n",
        f"  if (!last) {{\n    STAMP({END});\n    return;\n  }}\n"
        f"  STAMP({LAST});\n", 1)
    src = insert(src, "  while (n > 1) {\n    n = merge_level(buf[k], D * n",
                 f"  STAMP({LEVEL1});\n")
    src = insert(src, "  // then the D > 1 shards, as shard_wave.combine",
                 f"  STAMP({MERGED});\n")
    src = insert(src, "  if (tid == 0) a.ticket[w] = 0u;\n}",
                 f"  STAMP({DONE});\n")
    return src + TAIL


def build():
    from volcano_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, "shard_wave.cu")) as f:
        src = instrumented_source(f.read())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "shard_wave_stamps.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                          _build.CSRC, "-o", lib, path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(res.stdout[-4000:] + res.stderr[-4000:])
    return ctypes.CDLL(lib)


def split(lib, call, warm=False):
    """One launch of the instrumented kernel on ``call``'s arguments (with
    ``warm``, right after another): the stages' medians and maxima over
    the blocks, in ns."""
    import numpy as np
    import torch

    import chip_smoke
    from volcano_tpu_torch.ops import shard_wave as sw
    cfg, D, C, args = call
    for _ in range(3):
        got = sw.shard_wave_cuda(cfg, D, C, args)
    torch.cuda.synchronize()
    want = sw.shard_wave_plain_combined(cfg, D, C, args)
    for g, w in zip(got, want):
        if not chip_smoke.bitwise_equal(g, w.contiguous()):
            raise SystemExit("the instrumented kernel differs from the "
                             "plain version")
    host = (ctypes.c_ulonglong * (MAX_BLOCKS * SLOTS))()
    ctypes.memset(host, 0, ctypes.sizeof(host))
    lib.read_stamps(host)          # the stamps of the launches so far
    before = np.frombuffer(host, dtype=np.uint64).copy()
    if warm:
        sw.shard_wave_cuda(cfg, D, C, args)
        lib.read_stamps(host)      # the first launch's stamps
        before = np.frombuffer(host, dtype=np.uint64).copy()
        # a launch to warm, then the one measured, back to back
        sw.shard_wave_cuda(cfg, D, C, args)
        sw.shard_wave_cuda(cfg, D, C, args)
    else:
        sw.shard_wave_cuda(cfg, D, C, args)
    lib.read_stamps(host)
    st = np.frombuffer(host, dtype=np.uint64).astype(np.int64)
    fresh = (st != before.astype(np.int64)) & (st > 0)
    st = np.where(fresh, st, 0).reshape(MAX_BLOCKS, SLOTS)
    W = args[0].shape[1]
    B, _, _ = sw.grid_shape(D, args[-1].shape[1] // D, W)
    st = st[:B * W * D]
    t0 = st[:, 0].min()
    # a slot the measured launch did not write (a block that was last in
    # the launch before it) holds an older stamp
    st = np.where(st >= t0, st, 0)
    rest = st[:, END] > 0
    names = [n for n, _ in STAMPS[1:]] + ["ticket"]
    out = dict(D=D, W=W, C=C, blocks=B * W * D, stages_ns={})
    for k, name in enumerate(names):
        nxt = np.where(rest, st[:, END], st[:, LAST]) if k + 1 == len(
            names) else st[:, k + 1]
        d = nxt - st[:, k]
        out["stages_ns"][name] = dict(median=float(np.median(d)),
                                      max=int(d.max()))
    out["block_end_ns"] = [int(x) for x in np.percentile(
        st[rest, END] - t0, [0, 50, 90, 100])]
    last = np.flatnonzero(st[:, DONE] > 0)
    out["last_blocks"] = [dict(
        last_ticket=int(st[b, LAST] - t0),
        level1=int(st[b, LEVEL1] - st[b, LAST]),
        shard_merge=int(st[b, MERGED] - st[b, LAST]),
        combine=int(st[b, DONE] - st[b, MERGED]),
        end=int(st[b, DONE] - t0)) for b in last]
    out["launch_ns"] = int(st[last, DONE].max() - t0)
    return out


def split_both(lib, call):
    """:func:`split` of a launch after other work on the card (the
    plain version's kernels ran last, as the walk's own kernels do between
    its waves) and of a launch right after a launch of the same kernel
    (``warm``: its code and the inputs cached on the SMs), to tell the
    cost of the kernel's first fetches from that of its work."""
    out = split(lib, call)
    out["warm"] = split(lib, call, warm=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import shard_wave as sw
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    lib = build()
    sw._launch = sw.bind(lib)
    ssn = Session(_synthetic_cluster(*chip_smoke.FULL),
                  chip_smoke.wave_conf(True), device="cuda")
    cfg, _, C, args = chip_smoke.record_wave_launches(ssn, keep=1,
                                                      stop_after=1)[0]
    out = dict(card=card, check_I_first_launch=[
        split_both(lib, (cfg, D, C, args)) for D in (1, 4)])
    text = json.dumps(out, indent=1)
    print(text)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)),
                    exist_ok=True)
        with open(opts.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
