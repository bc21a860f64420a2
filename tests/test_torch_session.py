"""The port's Session against the JAX Session, and the port's isolation.

Each package builds the same cluster with its own ``api`` from one seed;
``run_allocate`` must give the same binds (task uid -> node, GPU card), the
same held placements and the same PodGroup phase updates.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import volcano_tpu.api as japi
import volcano_tpu_torch.api as tapi

from torch_fixtures import (HDRF_SCENARIO, affinity_cluster, hdrf_cluster,
                            random_cluster, session_pair)
from volcano_tpu_torch.framework import (PluginOption, SchedulerConfiguration,
                                         Session, Tier, parse_conf)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "conf", "volcano-scheduler.conf")) as _f:
    SHIPPED = _f.read()

CONFS = {
    "gang_binpack": "actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
                    "  - name: binpack\n",
    "priority_gang_conformance": "actions: allocate\ntiers:\n- plugins:\n"
                                 "  - name: priority\n  - name: gang\n"
                                 "  - name: conformance\n",
    "scaled_allocatable": "actions: allocate\ntiers:\n- plugins:\n"
                          "  - name: gang\n  - name: binpack\n"
                          "configurations:\n- name: scaleallocatable\n"
                          "  arguments:\n    millicpu: 0.5\n",
    "binpack_weighted": "actions: allocate\ntiers:\n- plugins:\n"
                        "  - name: priority\n  - name: gang\n"
                        "  - name: binpack\n    arguments:\n"
                        "      binpack.weight: 2.5\n",
    # the built-in default (framework/conf.py) and the shipped
    # conf/volcano-scheduler.conf: drf, proportion, predicates, nodeorder
    "builtin_default": None,
    "shipped": SHIPPED,
    "drf_hdrf": "actions: allocate\ntiers:\n- plugins:\n  - name: drf\n"
                "    enableHierarchy: true\n  - name: predicates\n"
                "  - name: nodeorder\n    arguments:\n"
                "      nodeaffinity.weight: 2\n",
}


def run_pair(build, conf_name):
    return session_pair(build, CONFS[conf_name])


@pytest.mark.parametrize("conf_name", sorted(CONFS))
@pytest.mark.parametrize("seed,kw", [(0, {}), (3, dict(gpus=True)),
                                     (5, dict(n_nodes=7, n_jobs=9,
                                              gpus=True, taints=True))])
def test_session_matches_jax_session(seed, kw, conf_name):
    want, got, ssn = run_pair(
        lambda api: random_cluster(api, seed, **kw), conf_name)
    assert got == want
    assert got[0], "nothing was bound"


def test_bulk_bind_matches_jax_session():
    """640 tasks: the vectorised bind path (512 binds and more)."""
    from __graft_entry__ import _synthetic_cluster as jax_synth
    from volcano_tpu_torch.synthetic import _synthetic_cluster as port_synth

    def build(api):
        synth = jax_synth if api is japi else port_synth
        return synth(64, 80, 8, seed=3)

    want, got, ssn = run_pair(build, "gang_binpack")
    assert got == want
    assert len(got[0]) >= 512
    node = ssn.cluster.nodes[next(iter(got[0].values()))[0]]
    assert node.tasks and node.used.get("cpu") > 0


def test_conf_from_dataclasses_needs_no_yaml():
    conf = SchedulerConfiguration(actions=["allocate"], tiers=[
        Tier([PluginOption("gang"), PluginOption("binpack")])])
    ci = random_cluster(tapi, 1)
    ssn = Session(ci, conf, device="cpu")
    cfg, _ = ssn._derived_allocate_inputs()
    assert cfg.batch_jobs == 8 and cfg.batch_rounds == 0
    assert cfg.binpack_weight == 1.0 and cfg.enable_gang
    ssn.run_allocate()
    assert ssn.binds


@pytest.mark.parametrize("name", ["tdm", "reservation", "task-topology"])
def test_unported_plugin_names_its_roadmap_item(name):
    conf = SchedulerConfiguration(tiers=[Tier([PluginOption(name)])])
    with pytest.raises(KeyError, match="ROADMAP queue 1 item 5b"):
        Session(random_cluster(tapi, 0), conf, device="cpu")


@pytest.mark.parametrize("name", ["overcommit", "sla"])
def test_ported_enqueue_plugins_build(name):
    conf = SchedulerConfiguration(tiers=[Tier([PluginOption(name)])])
    ssn = Session(random_cluster(tapi, 0), conf, device="cpu")
    assert ssn.plugin(name) is not None


@pytest.mark.parametrize("conf_name", ["shipped", "builtin_default",
                                       "drf_hdrf"])
@pytest.mark.parametrize("seed", [1, 4])
def test_node_affinity_and_volumes_match_jax_session(seed, conf_name):
    """predicates + nodeorder feed the cycle node-affinity OR groups,
    preferred-term scores and volume pins (framework/host_extras.py)."""
    want, got, ssn = run_pair(lambda api: affinity_cluster(api, seed),
                              conf_name)
    assert got == want
    assert got[0], "nothing was bound"
    _, extras = ssn._derived_allocate_inputs()
    assert (extras.task_or_group >= 0).any()
    assert extras.template_na_score.any()
    assert not extras.task_volume_ok.all()


def test_shipped_conf_session_at_subscale():
    """(64 nodes, 120 gangs of 8): the shipped conf's dynamic-key path
    through a Session, with the vectorised bind path (512 binds and
    more), against the JAX Session."""
    from __graft_entry__ import _synthetic_cluster as jax_synth
    from volcano_tpu_torch.synthetic import _synthetic_cluster as port_synth

    def build(api):
        synth = jax_synth if api is japi else port_synth
        ci = synth(64, 120, 8, seed=5)
        for q in range(4):
            ci.add_queue(api.QueueInfo(f"q{q}", weight=1 + q))
        for j, job in enumerate(ci.jobs.values()):
            job.queue = f"q{j % 4}"
        return ci

    want, got, ssn = run_pair(build, "shipped")
    assert got == want
    assert len(got[0]) >= 512
    cfg, extras = ssn._derived_allocate_inputs()
    assert cfg.batch_rounds > 0 and cfg.drf_ns_order
    assert np.isfinite(extras.queue_deserved).any()


def test_chip_smoke_conf_is_the_shipped_conf():
    """chip_smoke.py builds conf/volcano-scheduler.conf from dataclasses
    (the card's machine has no PyYAML): the same configuration."""
    import chip_smoke
    assert chip_smoke.shipped_conf() == parse_conf(SHIPPED)


def test_hierarchy_matches_jax():
    """The hdrf tree of the hdrf_test.go scenario, and the Session with
    hierarchical drf on it."""
    from volcano_tpu.arrays import pack as jax_pack
    from volcano_tpu.arrays.hierarchy import build_hierarchy as jax_build

    from volcano_tpu_torch.arrays import pack
    from volcano_tpu_torch.arrays.hierarchy import build_hierarchy
    ci = hdrf_cluster(japi, *HDRF_SCENARIO)
    snap, maps = jax_pack(ci)
    Q, J = snap.queues.weight.shape[0], snap.jobs.valid.shape[0]
    want = jax_build(ci, maps, Q, J)
    port_ci = hdrf_cluster(tapi, *HDRF_SCENARIO)
    got = build_hierarchy(port_ci, pack(port_ci)[1], Q, J)
    for f in ("parent", "depth", "weight", "valid", "queue_path",
              "job_leaf"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f))
    assert got.queue_path.shape[1] == 3


def test_port_imports_without_jax():
    """Every module of the port imports (``parallel/``,
    ``ops/shard_placer.py``, ``ops/shard_wave.py``, ``analysis/``,
    ``actions/``, ``ops/enqueue.py`` and ``ops/backfill.py`` among them),
    and a session runs, with ``jax`` and ``volcano_tpu`` blocked; with
    ``sharding: true`` too, and with ``wave_width: 8`` on top; and the
    enqueue, allocate, backfill actions, the planted sharding check and
    ``run_allocate_oracle`` (``runtime/cpu_reference.py``) on a cluster
    of 12 resource dims run."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'volcano_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, volcano_tpu_torch\n"
        "for m in pkgutil.walk_packages(volcano_tpu_torch.__path__,\n"
        "                               'volcano_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from volcano_tpu_torch.synthetic import _synthetic_cluster\n"
        "from volcano_tpu_torch.framework import (Session, Tier,\n"
        "    PluginOption, SchedulerConfiguration)\n"
        "conf = SchedulerConfiguration(tiers=[Tier([PluginOption('gang'),\n"
        "                                           PluginOption('binpack')])])\n"
        "ssn = Session(_synthetic_cluster(16, 8, 4), conf, device='cpu')\n"
        "ssn.run_allocate()\n"
        "assert ssn.binds\n"
        "first = [b.node_name for b in ssn.binds]\n"
        "assert ssn.reopen(now=ssn.now)\n"
        "ssn.run_allocate()\n"
        "assert ssn.stats['last_kind'] == 'delta'\n"
        "conf.sharding = True\n"
        "sharded = Session(_synthetic_cluster(16, 8, 4), conf, device='cpu')\n"
        "sharded.run_allocate()\n"
        "assert sharded._sharding_mesh().size == 1\n"
        "assert [b.node_name for b in sharded.binds] == "
        "first\n"
        "conf.wave_width = 8\n"
        "from volcano_tpu_torch.ops import shard_wave\n"
        "wave = Session(_synthetic_cluster(16, 8, 4), conf, device='cpu')\n"
        "wave.run_allocate()\n"
        "assert shard_wave.waves > 0\n"
        "assert [b.node_name for b in wave.binds] == "
        "first\n"
        "from volcano_tpu_torch.actions import get_action\n"
        "from volcano_tpu_torch.synthetic import admission_scenario\n"
        "conf = chip_smoke.check_k_conf()\n"
        "adm = Session(admission_scenario(16, 12, 4, 8), conf, now=4149.0,\n"
        "              device='cpu')\n"
        "for name in conf.actions:\n"
        "    get_action(name).execute(adm)\n"
        "assert adm.stats['enqueued'] and adm.stats['backfilled']\n"
        "import torch\n"
        "from volcano_tpu_torch.analysis.sharding import (planted_gather,\n"
        "    pallas_block_findings)\n"
        "x, out, rec, rows = planted_gather(2, 32, 4, 'cpu')\n"
        "assert torch.equal(out, x * 2)\n"
        "assert pallas_block_findings(rec, 32, rows, 'planted')\n"
        "orc = Session(_synthetic_cluster(16, 8, 4, extended=10),\n"
        "              SchedulerConfiguration(tiers=[Tier([\n"
        "                  PluginOption('gang'), PluginOption('binpack')])]),\n"
        "              device='cpu')\n"
        "orc.run_allocate_oracle()\n"
        "assert orc.binds and orc.stats['cpu_oracle'] == 1.0\n"
        "for m in ('volcano_tpu_torch.parallel.sharding',\n"
        "          'volcano_tpu_torch.runtime',\n"
        "          'volcano_tpu_torch.runtime.cpu_reference',\n"
        "          'volcano_tpu_torch.ops.fused_io',\n"
        "          'volcano_tpu_torch.ops.shard_placer',\n"
        "          'volcano_tpu_torch.ops.shard_wave',\n"
        "          'volcano_tpu_torch.ops.enqueue',\n"
        "          'volcano_tpu_torch.ops.backfill',\n"
        "          'volcano_tpu_torch.analysis.sharding',\n"
        "          'volcano_tpu_torch.actions'):\n"
        "    assert m in sys.modules, m\n"
        "assert not any(k.split('.')[0] in ('jax', 'volcano_tpu')\n"
        "               and v is not None for k, v in sys.modules.items())\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_source_never_names_the_jax_package():
    import re
    bad = re.compile(r"^\s*(import jax|from jax|import volcano_tpu\b|"
                     r"from volcano_tpu\b|from \.\.\.)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "volcano_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not bad.search(f.read()), path


def test_default_device_is_the_card():
    import inspect
    assert inspect.signature(Session).parameters["device"].default == "cuda"
