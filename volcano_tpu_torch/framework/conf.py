"""Scheduler policy configuration: actions list + plugin tiers.

Reference: pkg/scheduler/conf/scheduler_conf.go:20-82 (SchedulerConfiguration,
Tier, PluginOption with Enabled* switches) and pkg/scheduler/util.go:31-92
(defaultSchedulerConf, unmarshalSchedulerConf incl. the hdrf+proportion
conflict check). Same YAML shape as the reference so existing conf files port
unchanged. A copy of ``volcano_tpu/framework/conf.py``, with PyYAML imported
only where YAML is parsed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

DEFAULT_SCHEDULER_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


@dataclass
class PluginOption:
    """One plugin entry in a tier (scheduler_conf.go:44-82)."""

    name: str
    arguments: Dict[str, str] = field(default_factory=dict)
    # Enabled* switches default to on, like the reference's nil-means-true
    # pointers (plugins.ApplyPluginConfDefaults).
    enabled_job_order: bool = True
    enabled_namespace_order: bool = True
    enabled_hierarchy: bool = False       # drf-only: hdrf
    enabled_job_ready: bool = True
    enabled_job_pipelined: bool = True
    enabled_task_order: bool = True
    enabled_preemptable: bool = True
    enabled_reclaimable: bool = True
    enabled_queue_order: bool = True
    enabled_predicate: bool = True
    enabled_best_node: bool = True
    enabled_node_order: bool = True
    enabled_target_job: bool = True
    enabled_reserved_nodes: bool = True
    enabled_job_enqueued: bool = True
    enabled_victim: bool = True
    enabled_job_starving: bool = True

    def get_argument(self, key: str, default=None):
        return self.arguments.get(key, default)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class Configuration:
    """Per-action arguments block (scheduler_conf.go:30-42, used by the
    fork's ScaleAllocatable / dap conf)."""

    name: str
    arguments: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfiguration:
    actions: List[str] = field(default_factory=lambda: ["enqueue", "allocate",
                                                        "backfill"])
    tiers: List[Tier] = field(default_factory=list)
    configurations: List[Configuration] = field(default_factory=list)
    #: in-graph cycle telemetry: compiles the CycleTelemetry /
    #: PreemptTelemetry / BackfillTelemetry counter blocks into the cycle
    #: programs. Default off — decisions are bit-identical either way, and
    #: the off-build's jaxprs carry zero telemetry equations. YAML:
    #: top-level ``telemetry: true``.
    telemetry: bool = False
    #: device-resident snapshot buffers with packed delta uploads
    #: (ops/fused_io.DeltaKernel): steady-state cycles ship O(changed
    #: elements) instead of re-uploading the full fused buffers. Decisions
    #: are bit-identical either way (the delta is a value-level diff
    #: against the mirror of device truth); ``delta_uploads: false``
    #: restores the full-upload path. YAML: top-level key.
    delta_uploads: bool = True
    #: one-deep pipelined scheduler loop (runtime/scheduler.py): dispatch
    #: the compiled cycle, defer the packed readback, and drain it at the
    #: top of the next run_once, overlapping device compute with host
    #: event ingestion. Default off — the synchronous loop is the
    #: reference semantics; see docs/architecture.md "Steady-state
    #: pipeline" for the exact apply-ordering contract. YAML: top-level
    #: ``pipeline: true``.
    pipeline: bool = False
    #: pipelined in-flight depth (runtime/scheduler.py pending ring): 1
    #: (default) keeps the depth-1 contract above unchanged; k > 1 lets
    #: up to k cycles be in flight, where cycles dispatched behind an
    #: undrained predecessor are SPECULATIVE — replayed decision-
    #: neutrally at drain if a predecessor applied decisions. Only
    #: meaningful with ``pipeline: true``. YAML: top-level
    #: ``pipeline_depth: 3``.
    pipeline_depth: int = 1
    #: opt-in persistent XLA compilation cache directory
    #: (framework/compile_cache.enable_compilation_cache); also settable
    #: via $VOLCANO_JAX_CACHE_DIR. None = disabled.
    compilation_cache_dir: Optional[str] = None
    #: per-cycle watchdog deadline for the dispatch/drain halves of the
    #: scheduler loop, in milliseconds. A cycle that blows it is
    #: retired synchronously (decisions unaffected) and the loop drops out
    #: of pipelining for the fault-cooldown window. None = no watchdog —
    #: the default, because a sane deadline is deployment-specific (it
    #: must exceed the cold-compile cycle). YAML: top-level
    #: ``cycle_deadline_ms: 500``.
    cycle_deadline_ms: Optional[float] = None
    #: node-axis sharded allocate cycle over a device mesh
    #: (parallel/sharding.py): one pop and one attempt at a time, each
    #: attempt one launch of the shard-local candidate kernel over every
    #: shard, the shards' winners combined as the reference combines them
    #: (or, with ``wave_width`` > 1, one wave of attempts a launch).
    #: Decisions are bit-identical to the unsharded path. Requires the
    #: delta path (``delta_uploads: true``, the default), as in the
    #: reference: with delta uploads off the knob is ignored. YAML:
    #: top-level ``sharding: true``.
    sharding: bool = False
    #: device-count cap for the sharded mesh (None = all local devices);
    #: the effective mesh is the largest power of two <= this that divides
    #: the packed node axis (parallel/sharding.mesh_for_nodes). YAML:
    #: top-level ``sharding_devices: 8``.
    sharding_devices: Optional[int] = None
    #: multi-host groundwork (parallel/distributed): number of host
    #: processes the mesh spans. None/1 (default) = single-process —
    #: initialize_distributed is a strict no-op. > 1 plus the
    #: $VOLCANO_COORDINATOR / $VOLCANO_PROCESS_ID env contract calls
    #: jax.distributed.initialize before mesh construction. YAML:
    #: top-level ``mesh_hosts: 2``.
    mesh_hosts: Optional[int] = None
    #: kernel-path override threaded into AllocateConfig.use_pallas:
    #: ``true`` compiles the allocate sweep as the pallas kernel,
    #: ``"interpret"`` runs the same kernel in interpreter mode (any N,
    #: CPU-friendly — what the chaos/failover probe's second leg uses),
    #: None (default) keeps the pure-XLA scan. YAML: top-level
    #: ``use_pallas: interpret``.
    use_pallas: Optional[object] = None
    #: wavefront task placement width, threaded into
    #: AllocateConfig.wave_width: on the sharded cycle each wave evaluates
    #: the next W slots of the popped job against the same capacity
    #: snapshot in one launch of the wide candidate kernel, then commits
    #: in strict task order with the conflict rule — the committed
    #: decision sequence is identical to W=1 at every width. The fused
    #: placers (no sharding) take whole job sections and ignore it.
    #: normalize_wave clamps illegal combinations (pod affinity / host
    #: ports force 1). YAML: top-level ``wave_width: 8``.
    wave_width: int = 1
    #: fleet runtime (volcano_tpu/fleet): max tenants served per fleet
    #: cycle. None (default) serves every admitted tenant each cycle; a
    #: finite value makes the cross-tenant fairness pass (the proportion
    #: plugin's weighted water-fill lifted one level up) pick the
    #: highest-deficit tenants under load. YAML: top-level
    #: ``fleet_slots: 8``.
    fleet_slots: Optional[int] = None
    #: fleet per-tenant checkpoint directory (one checkpoint envelope per
    #: tenant, ``tenant-<name>.vckp`` — a corrupt file cold-fuses only its
    #: own tenant). None = checkpointing only via explicit
    #: FleetScheduler.checkpoint(dir) calls. YAML: top-level
    #: ``fleet_checkpoint_dir: /var/run/volcano``.
    fleet_checkpoint_dir: Optional[str] = None

    def plugin_option(self, name: str) -> Optional[PluginOption]:
        for tier in self.tiers:
            for opt in tier.plugins:
                if opt.name == name:
                    return opt
        return None

    def enabled(self, name: str) -> bool:
        return self.plugin_option(name) is not None

    def action_arguments(self, action: str) -> Dict[str, Any]:
        for c in self.configurations:
            if c.name == action:
                return c.arguments
        return {}


_BOOL_KEYS = {
    "enableJobOrder": "enabled_job_order",
    "enableNamespaceOrder": "enabled_namespace_order",
    "enableHierarchy": "enabled_hierarchy",
    "enableJobReady": "enabled_job_ready",
    "enableJobPipelined": "enabled_job_pipelined",
    "enableTaskOrder": "enabled_task_order",
    "enablePreemptable": "enabled_preemptable",
    "enableReclaimable": "enabled_reclaimable",
    "enableQueueOrder": "enabled_queue_order",
    "enablePredicate": "enabled_predicate",
    "enableBestNode": "enabled_best_node",
    "enableNodeOrder": "enabled_node_order",
    "enableTargetJob": "enabled_target_job",
    "enableReservedNodes": "enabled_reserved_nodes",
    "enableJobEnqueued": "enabled_job_enqueued",
    "enableVictim": "enabled_victim",
    "enableJobStarving": "enabled_job_starving",
}


def parse_conf(text: Optional[str] = None) -> SchedulerConfiguration:
    """Parse reference-shaped YAML; raises ValueError on the hdrf+proportion
    conflict exactly like unmarshalSchedulerConf (util.go:60-71).

    Needs PyYAML; a caller without it builds :class:`SchedulerConfiguration`
    from the dataclasses above."""
    import yaml
    data = yaml.safe_load(text or DEFAULT_SCHEDULER_CONF) or {}
    sc = SchedulerConfiguration()
    sc.telemetry = bool(data.get("telemetry", False))
    sc.delta_uploads = bool(data.get("delta_uploads", True))
    sc.pipeline = bool(data.get("pipeline", False))
    sc.pipeline_depth = max(1, int(data.get("pipeline_depth", 1) or 1))
    cache_dir = data.get("compilation_cache_dir")
    sc.compilation_cache_dir = str(cache_dir) if cache_dir else None
    ddl = data.get("cycle_deadline_ms")
    sc.cycle_deadline_ms = float(ddl) if ddl else None
    sc.sharding = bool(data.get("sharding", False))
    sd = data.get("sharding_devices")
    sc.sharding_devices = int(sd) if sd is not None else None
    mh = data.get("mesh_hosts")
    sc.mesh_hosts = int(mh) if mh is not None else None
    sc.use_pallas = data.get("use_pallas")
    sc.wave_width = max(1, int(data.get("wave_width", 1) or 1))
    fs = data.get("fleet_slots")
    sc.fleet_slots = int(fs) if fs is not None else None
    fcd = data.get("fleet_checkpoint_dir")
    sc.fleet_checkpoint_dir = str(fcd) if fcd else None
    raw_actions = data.get("actions", "enqueue, allocate, backfill")
    if isinstance(raw_actions, str):
        sc.actions = [a.strip() for a in raw_actions.split(",") if a.strip()]
    else:
        sc.actions = list(raw_actions)

    hdrf = proportion = False
    for tier_data in data.get("tiers", []) or []:
        tier = Tier()
        for p in tier_data.get("plugins", []) or []:
            opt = PluginOption(name=p["name"],
                               arguments=dict(p.get("arguments") or {}))
            for yaml_key, attr in _BOOL_KEYS.items():
                if yaml_key in p:
                    setattr(opt, attr, bool(p[yaml_key]))
            if opt.name == "drf" and opt.enabled_hierarchy:
                hdrf = True
            if opt.name == "proportion":
                proportion = True
            tier.plugins.append(opt)
        sc.tiers.append(tier)
    if hdrf and proportion:
        raise ValueError("proportion and drf with hierarchy enabled conflicts")

    for c in data.get("configurations", []) or []:
        sc.configurations.append(
            Configuration(name=c["name"], arguments=dict(c.get("arguments") or {})))
    if not sc.tiers:
        sc.tiers = parse_conf(DEFAULT_SCHEDULER_CONF).tiers
    return sc
