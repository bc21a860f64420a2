"""Metric registry with Prometheus text exposition (the port's copy of
``volcano_tpu/metrics/metrics.py``, standard library only).

Reference metric families (pkg/scheduler/metrics/):
- metrics.go:38-202 — e2e_scheduling_latency_milliseconds,
  action/plugin_scheduling_latency_microseconds,
  task_scheduling_latency_milliseconds, schedule_attempts_total,
  preemption_victims, unschedule_task_count;
- queue.go:28-284 — per-queue allocated/request/deserved (milli_cpu +
  memory_bytes), share, weight, overused, pod-group phase counts;
- namespace.go:28-63 — namespace share/weight/weighted_share.

Histograms expose full cumulative bucket series (le labels + +Inf) so
reference-style latency quantile dashboards work against /metrics.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Mapping, Tuple, Union

#: millisecond-valued histograms (e2e / task scheduling latency)
_BUCKETS_MS = [5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000]

#: microsecond-valued histograms (action / plugin latency). Every
#: histogram used to share the millisecond series above, so any action
#: slower than 10 ms (= 10000 us) fell straight into +Inf — per-metric
#: bucket sets fix the mismatch (50 us .. 10 s, roughly the reference's
#: prometheus.ExponentialBuckets(5, 2, ...) span).
_BUCKETS_US = [50, 100, 250, 500, 1000, 2500, 5000, 10000, 25000, 50000,
               100000, 250000, 500000, 1000000, 2500000, 5000000, 10000000]

LabelsT = Union[str, Mapping[str, str], None]

#: `# HELP` text per metric base name; names without an entry get a
#: generated default so strict parsers always see HELP/TYPE pairs.
_HELP = {
    "e2e_scheduling_latency_milliseconds":
        "E2E scheduling latency in ms (scheduling algorithm + binding)",
    "action_scheduling_latency_microseconds":
        "Action scheduling latency in microseconds",
    "plugin_scheduling_latency_microseconds":
        "Plugin scheduling latency in microseconds",
    "task_scheduling_latency_milliseconds":
        "Task scheduling latency in milliseconds",
    "schedule_attempts_total":
        "Number of attempts to schedule pods, by result",
    "unschedule_task_count":
        "Number of tasks that could not be scheduled, by reason",
    "cycle_predicate_rejections":
        "In-graph per-predicate-family node rejection counts",
    "wave_commits_total":
        "Tasks committed by wavefront placement waves (wave_width > 1)",
    "wave_truncations_total":
        "Wavefront waves cut short by the in-graph conflict rule "
        "(pre-wave candidate list exhausted by same-wave commits)",
    "wave_replays_total":
        "Task attempts deferred to the next wave by a truncation",
    "wave_commit_ratio":
        "Last cycle's wavefront commit efficiency: commits / (commits + "
        "replays); 1.0 = every wave slot committed first try",
    "jit_traces": "Times each jitted cycle entry point was traced",
    "jit_calls": "Times each jitted cycle entry point was called",
    "jit_cache_hits": "Jit calls served from the compile cache",
    "resident_digest_mismatch_total":
        "Device-resident buffer integrity digest mismatches vs the host "
        "mirror (each one triggered a full re-fuse recovery)",
    "cycle_recoveries_total":
        "Scheduling cycles recovered in place, by reason and mode "
        "(refuse / sync / cpu_oracle)",
    "cycle_faults_total":
        "Faults absorbed by the cycle runtime, by stage",
    "cycle_dropped_total":
        "Cycles retired with no decisions after recovery failed",
    "resync_dead_letter_total":
        "Bind/evict intents that exhausted resync retries and moved to "
        "the dead-letter list (never dropped silently)",
    "degradation_level":
        "Current degradation ladder rung: 0 pipelined, 1 sync, "
        "2 elastic-mesh (shrunk sharded), 3 cpu-oracle",
    "mesh_shrink_total":
        "Elastic-mesh shrinks: device quarantines that halved the "
        "serving-width cap and rebuilt the mesh over the survivors, "
        "by reason",
    "mesh_regrow_total":
        "Elastic-mesh probation regrows: cap lifted a pow2 step back "
        "toward the full mesh after a quiet probation interval",
    "mesh_width":
        "Serving mesh width (devices) observed at the last finished "
        "sharded cycle",
    "sidecar_reconnects_total":
        "Sidecar client reconnects after a socket failure",
    "sidecar_replayed_rounds_total":
        "VCRQ rounds served from the idempotent replay cache",
    "sidecar_epoch_restored_total":
        "Mid-stream rounds rejected with ERR_EPOCH_RESTORED after a "
        "server restart (side=server) and client re-primes that followed "
        "(side=client)",
    # crash-consistent checkpoint/restore (runtime/checkpoint.py)
    "checkpoint_write_total":
        "Crash-consistent checkpoints written (atomic tmp+fsync+rename), "
        "by kind (scheduler / sidecar)",
    "checkpoint_restore_total":
        "Restore attempts by outcome: restored (warm), cold (no "
        "checkpoint), fallback (corrupt / version-skewed / mismatched "
        "checkpoint degraded to a fresh-fuse cold start)",
    "checkpoint_mirror_invalid_total":
        "Checkpointed host mirrors dropped at restore because their "
        "integrity digest no longer matched (cold re-fuse instead)",
    "checkpoint_warm_refuse_total":
        "Resident states re-fused warm from a restored checkpoint mirror "
        "(the delta path survived the restart)",
    "crash_loop_restarts_total":
        "Supervised serve-loop restarts after a crash (capped backoff)",
    "resync_redrive_total":
        "Dead-letter resync intents re-driven back to pending after a "
        "successful restore",
    "span_phase_ms":
        "Host span duration quantiles per cycle phase (ring-buffered "
        "p50/p95/p99 from telemetry.spans — the SLO latency surface)",
    "pipeline_overlap_fraction":
        "Fraction of the in-flight device window covered by non-blocked "
        "host work (telemetry.spans occupancy; ~0 when synchronous)",
    "pipeline_bubble_ms":
        "In-flight device window time the host spent idle or blocked "
        "(the pipeline bubble the deep-async item must shrink)",
    # scheduling-quality scorecards (the scenarios engine): one gauge set
    # per scenario run, the same numbers /api/scenarios and the bench
    # `scenarios` block carry
    "quality_makespan_cycles":
        "Scenario makespan in virtual cycles (first arrival to last "
        "job completion)",
    "quality_drf_share_error":
        "Mean per-cycle DRF share error: |allocated - deserved| summed "
        "over queues, normalized by cluster capacity (0 = fair)",
    "quality_node_utilization":
        "Mean per-cycle allocated/capacity cpu fraction over the "
        "scenario run",
    "quality_preemption_churn_total":
        "Evictions the scenario run produced (preempt + reclaim churn)",
    "quality_queue_wait_cycles":
        "Queue-wait quantiles in virtual cycles (arrival to first bind), "
        "nearest-rank p50/p95/p99",
    "quality_jobs_completed":
        "Jobs that ran to completion inside the scenario horizon",
    "quality_drift_failures":
        "Soak-mode CPU-oracle drift spot-checks where compiled decisions "
        "diverged from the oracle (must stay 0)",
    # high availability: leader election, lease fencing, checkpoint
    # streaming, warm-standby failover (runtime/{leader,replication}.py)
    "leader_transitions_total":
        "Leadership transitions observed by this scheduler, by "
        "destination role (to=leader / to=follower)",
    "is_leader":
        "1 while this scheduler holds the leader lease, else 0",
    "fenced_writes_rejected_total":
        "Bind/evict writes rejected because they carried a superseded "
        "lease-generation fencing token (a deposed leader's late "
        "writes), by kind",
    "replication_envelopes_total":
        "Checkpoint-stream envelopes by delivery result (applied / lost "
        "/ resync_gap / resync_invalid / resync_applied ...)",
    "replication_mirror_invalid_total":
        "Streamed mirror records the standby refused because their "
        "integrity digest did not match (never adopted)",
    "replication_lag_seq":
        "Envelopes the warm standby lags behind the leader's stream "
        "(0 in the steady state)",
    "failover_promotions_total":
        "Warm-standby promotions by ladder rung: warm (replicated "
        "state + mirrors adopted), cold (nothing replicated), fallback "
        "(conf-fingerprint mismatch, fresh cold start)",
    "sidecar_failovers_total":
        "Sidecar client reconnects that landed on a DIFFERENT endpoint "
        "of the replica set (each costs one pipeline re-prime)",
    "sidecar_not_leader_total":
        "Sidecar rounds rejected with ERR_NOT_LEADER because their "
        "fencing token was superseded",
    # multi-tenant fleet runtime
    "fleet_tenants":
        "Tenants currently admitted to the fleet scheduler",
    "fleet_cycles_total":
        "Fleet serving cycles completed, by tenant",
    "fleet_admissions_total":
        "Fleet admission-control events, by event (admit / evict)",
    "fleet_tenant_degradation":
        "Per-tenant degradation ladder rung: 0 batched fleet path, "
        "1 sync retry, 2 cpu-oracle",
    "sidecar_replay_evictions_total":
        "Per-tenant sidecar replay-cache epochs evicted by the bounded "
        "LRU (VOLCANO_SIDECAR_EPOCH_CAP)",
    # per-cycle decision readback gauges (telemetry.publish)
    "cycle_tasks_allocated":
        "Tasks bound to nodes by the last scheduling cycle",
    "cycle_tasks_pipelined":
        "Tasks the last cycle carried as pipelined (in-flight) work",
    "cycle_gang_discarded_tasks":
        "Tasks discarded by the in-graph gang (minAvailable) filter in "
        "the last cycle",
    "cycle_argmax_ties":
        "Node-score argmax ties broken by index order in the last cycle "
        "(a proxy for score-plateau sensitivity)",
    "cycle_rounds":
        "Scheduling rounds the last cycle's fixed-trip scan executed",
    "cycle_pops":
        "Priority-queue pops the last cycle performed in-graph",
    "cycle_dyn_launches":
        "Segments the dynamic early-stop cycle launched last cycle",
    "cycle_dyn_early_stops":
        "Dynamic cycles that stopped before the worst-case trip count "
        "because the queue drained",
    "cycle_replays_total":
        "Wavefront task attempts replayed into a later wave by the "
        "host-side runtime (cumulative across cycles)",
    "cycle_upload_bytes":
        "Host-to-device bytes uploaded by the last delta fuse (the "
        "O(changed rows) payload, not the full snapshot)",
    "sharded_resharding_copies_total":
        "Resident buffers that left a sharded cycle with a different "
        "sharding than they entered (must stay 0: each one is a "
        "per-iteration resharding copy)",
    # DRF / queue scorecard gauges (update_queue_family), mirroring
    # upstream volcano's queue_* exposition names
    "queue_allocated_milli_cpu":
        "CPU milli-cores currently allocated to the queue",
    "queue_allocated_memory_bytes":
        "Memory bytes currently allocated to the queue",
    "queue_request_milli_cpu":
        "CPU milli-cores requested by the queue's pending+running tasks",
    "queue_request_memory_bytes":
        "Memory bytes requested by the queue's pending+running tasks",
    "queue_deserved_milli_cpu":
        "CPU milli-cores the DRF plugin computed as the queue's "
        "deserved share",
    "queue_deserved_memory_bytes":
        "Memory bytes the DRF plugin computed as the queue's deserved "
        "share",
    "queue_share":
        "Dominant-resource share of the queue (allocated / deserved)",
    "queue_weight":
        "Configured scheduling weight of the queue",
    "queue_overused":
        "1 if the queue's share exceeds its deserved allocation, else 0",
    "queue_pod_group_inqueue_count":
        "PodGroups of the queue in Inqueue state",
    "queue_pod_group_pending_count":
        "PodGroups of the queue in Pending state",
    "queue_pod_group_running_count":
        "PodGroups of the queue in Running state",
    "queue_pod_group_unknown_count":
        "PodGroups of the queue in Unknown state",
    "namespace_share":
        "Dominant-resource share of the namespace",
    "namespace_weight":
        "Configured scheduling weight of the namespace",
    "namespace_weighted_share":
        "Namespace share divided by its weight (the value proportion "
        "plugins compare across namespaces)",
    # fleet resync / dispatch counters (fleet/scheduler.py)
    "resync_retried":
        "Bind/evict intents re-driven by the fleet resync loop",
    "resync_succeeded":
        "Bind/evict intents the fleet resync loop confirmed applied",
    "resync_dropped":
        "Bind/evict intents the fleet resync loop abandoned after "
        "exhausting retries",
    "resync_tasks":
        "Tasks touched by the last fleet resync sweep",
    "schedule_attempts":
        "Fleet per-tenant schedule attempts, by result",
}


def _label_str(labels: LabelsT, default_key: str = "queue") -> str:
    """Canonical `k="v",...` body (sorted) for a label set; a bare string
    keeps the historical queue-label shorthand."""
    if labels is None:
        return ""
    if isinstance(labels, str):
        return f'{default_key}="{labels}"'
    return ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))


class Histogram:
    def __init__(self, buckets: List[float]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        self.total += value
        self.n += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        #: (name, label_str) -> value. Bare .inc(name) keys on (name, "")
        #: so existing callers are unchanged; labeled counters carry the
        #: reference's label sets (schedule_attempts_total{result=...},
        #: unschedule_task_count{reason=...}).
        self.counters: Dict[Tuple[str, str], float] = defaultdict(float)
        self.gauges: Dict[Tuple[str, str], float] = {}
        self.histograms: Dict[Tuple[str, str], Histogram] = {}

    def inc(self, name: str, value: float = 1.0,
            labels: LabelsT = None) -> None:
        with self._lock:
            self.counters[(name, _label_str(labels))] += value

    def counter_value(self, name: str, labels: LabelsT = None) -> float:
        """Read a counter (0.0 when never incremented)."""
        with self._lock:
            return self.counters.get((name, _label_str(labels)), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across ALL label sets (0.0 when absent)."""
        with self._lock:
            return sum(v for (n, _ls), v in self.counters.items()
                       if n == name)

    def set_gauge(self, name: str, labels: LabelsT, value: float) -> None:
        with self._lock:
            self.gauges[(name, _label_str(labels))] = value

    def _hist(self, name: str, labels: LabelsT = None,
              buckets=None) -> Histogram:
        key = (name, _label_str(labels))
        if key not in self.histograms:
            self.histograms[key] = Histogram(buckets or _BUCKETS_MS)
        return self.histograms[key]

    def observe_cycle(self, seconds: float) -> None:
        """volcano_e2e_scheduling_latency_milliseconds (metrics.go:38-45)."""
        with self._lock:
            self._hist("e2e_scheduling_latency_milliseconds").observe(
                seconds * 1000)

    def observe_action(self, action: str, seconds: float) -> None:
        """volcano_action_scheduling_latency_microseconds (metrics.go:74-81).
        Microsecond values get the microsecond bucket series (_BUCKETS_US);
        the former shared millisecond buckets put anything over 10 ms in
        +Inf."""
        with self._lock:
            self._hist("action_scheduling_latency_microseconds",
                       {"action": action},
                       buckets=_BUCKETS_US).observe(seconds * 1e6)

    def observe_plugin(self, plugin: str, event: str, seconds: float) -> None:
        """volcano_plugin_scheduling_latency_microseconds (metrics.go:65-72,
        recorded around OnSessionOpen/Close, framework.go:47-60)."""
        with self._lock:
            self._hist("plugin_scheduling_latency_microseconds",
                       {"plugin": plugin, "event": event},
                       buckets=_BUCKETS_US).observe(seconds * 1e6)

    def observe_task_latency(self, seconds: float) -> None:
        """volcano_task_scheduling_latency_milliseconds (metrics.go:83-90)."""
        with self._lock:
            self._hist("task_scheduling_latency_milliseconds").observe(
                seconds * 1000)

    # ------------------------------------------------- gauge families
    def update_queue_family(self, queue: str, *, allocated_milli_cpu: float,
                            allocated_memory_bytes: float,
                            request_milli_cpu: float,
                            request_memory_bytes: float,
                            deserved_milli_cpu: float,
                            deserved_memory_bytes: float,
                            share: float, weight: float,
                            overused: bool,
                            pg_inqueue: int, pg_pending: int,
                            pg_running: int, pg_unknown: int) -> None:
        """The queue.go:28-284 gauge families for one queue."""
        g = self.set_gauge
        g("queue_allocated_milli_cpu", queue, allocated_milli_cpu)
        g("queue_allocated_memory_bytes", queue, allocated_memory_bytes)
        g("queue_request_milli_cpu", queue, request_milli_cpu)
        g("queue_request_memory_bytes", queue, request_memory_bytes)
        g("queue_deserved_milli_cpu", queue, deserved_milli_cpu)
        g("queue_deserved_memory_bytes", queue, deserved_memory_bytes)
        g("queue_share", queue, share)
        g("queue_weight", queue, weight)
        g("queue_overused", queue, 1.0 if overused else 0.0)
        g("queue_pod_group_inqueue_count", queue, pg_inqueue)
        g("queue_pod_group_pending_count", queue, pg_pending)
        g("queue_pod_group_running_count", queue, pg_running)
        g("queue_pod_group_unknown_count", queue, pg_unknown)

    def update_namespace_family(self, namespace: str, share: float,
                                weight: float) -> None:
        """namespace.go:28-63: share, weight, weighted share."""
        labels = {"namespace_name": namespace}
        self.set_gauge("namespace_share", labels, share)
        self.set_gauge("namespace_weight", labels, weight)
        self.set_gauge("namespace_weighted_share", labels,
                       share / weight if weight else share)

    def update_queue_metrics(self, queue: str, allocated_cpu: float,
                             deserved_cpu: float, share: float) -> None:
        """Back-compat shim over the full family (queue.go:28-284)."""
        self.set_gauge("queue_allocated_milli_cpu", queue, allocated_cpu)
        self.set_gauge("queue_deserved_milli_cpu", queue, deserved_cpu)
        self.set_gauge("queue_share", queue, share)

    @staticmethod
    def _meta_lines(lines, seen, name: str, mtype: str) -> None:
        """Emit `# HELP` / `# TYPE` once per metric base name, ahead of its
        first sample — strict Prometheus parsers require the pair; the
        sample line format itself is unchanged."""
        if name in seen:
            return
        seen.add(name)
        help_text = _HELP.get(name, name.replace("_", " "))
        lines.append(f"# HELP volcano_{name} {help_text}")
        lines.append(f"# TYPE volcano_{name} {mtype}")

    def exposition(self) -> str:
        """Prometheus text format (the /metrics endpoint payload), with
        `# HELP` / `# TYPE` metadata and full cumulative histogram bucket
        series."""
        lines = []
        seen = set()
        with self._lock:
            for (name, labels), v in sorted(self.counters.items()):
                self._meta_lines(lines, seen, name, "counter")
                suffix = f"{{{labels}}}" if labels else ""
                lines.append(f"volcano_{name}{suffix} {v}")
            for (name, labels), v in sorted(self.gauges.items()):
                self._meta_lines(lines, seen, name, "gauge")
                suffix = f"{{{labels}}}" if labels else ""
                lines.append(f"volcano_{name}{suffix} {v}")
            for (name, labels), h in sorted(self.histograms.items()):
                self._meta_lines(lines, seen, name, "histogram")
                prefix = f"{labels}," if labels else ""
                cum = h.cumulative()
                for b, c in zip(h.buckets, cum):
                    lines.append(
                        f'volcano_{name}_bucket{{{prefix}le="{b}"}} {c}')
                lines.append(
                    f'volcano_{name}_bucket{{{prefix}le="+Inf"}} {cum[-1]}')
                suffix = f"{{{labels}}}" if labels else ""
                lines.append(f"volcano_{name}_count{suffix} {h.n}")
                lines.append(f"volcano_{name}_sum{suffix} {h.total}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


#: process-global registry, like the prometheus default registerer
METRICS = Metrics()
