"""The scheduler loop: snapshot -> session -> actions -> bind (the port of
``volcano_tpu/runtime/scheduler.py``'s synchronous loop).

Reference: pkg/scheduler/scheduler.go:54-171 (Scheduler.Run / runOnce with
the 1 s wait.Until cycle, conf hot reload) and cmd/scheduler/app/server.go.
Each ``run_once`` processes the due resync retries, opens the cycle's
Session (the persistent one over the cluster's live view, re-opened from
its dirty marks), runs the conf's actions, and then flushes: the PodGroup
phase write-back, the evict and bind intents to the cluster (a refused
bind holds its task in Binding and goes to the rate-limited resync
queue), the metrics and the flight record. The reference fires the
intents as goroutines mid-cycle; the external effect is the same,
recorded in order.

The loop runs on the card unless the caller asks for the CPU
(``device="cpu"``); every Session it opens takes that device.

What this loop does not carry, and what it does instead:

- the pipelined loop (conf ``pipeline: true`` or ``pipeline=True`` at
  construction; as in the reference, a hot reload keeps the mode), its
  ``warmup`` and the degradation ladder are the next slice of ROADMAP
  item 2b; asking for them raises. An exception in any action, allocate
  included, leaves ``run_once``: nothing is flushed to the cluster and
  ``cycles`` does not advance;
- an ``elector`` (leader election and fencing) and ``checkpoint`` /
  ``checkpoint_state`` / ``restore`` are ROADMAP item 8, and raise;
- ``sharding: true`` runs the Session's one-card mesh path; the device
  health registry's tick of the reference (``HEALTH.tick``) is ROADMAP
  item 6c and does not run;
- ``compilation_cache_dir`` names an XLA compilation cache, which has no
  counterpart: the port's kernels build once into
  ``volcano_tpu_torch/_build/``. The loop accepts the option and does
  nothing with it;
- the reference publishes its jit trace counters each cycle
  (``telemetry.publish_gauges``); the port has no jit traces, so only
  the span gauges (``spans.publish_gauges``) are published;
- the chaos seams are ROADMAP item 10.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ..framework.conf import SchedulerConfiguration, parse_conf
from ..framework.session import Session
from ..metrics import METRICS
from ..telemetry import FlightRecorder, spans
from .fake_cluster import FakeCluster

#: what the loop refuses -> the ROADMAP item that ports it
_NEXT_SLICE = ("ROADMAP queue 1 item 2b, the next slice: the one-deep "
               "pipelined loop and its degradation ladder")
_SERVED = "ROADMAP queue 1 item 8 (served path, crash recovery, HA)"


class ResyncQueue:
    """Rate-limited retry queue for failed bind/evict dispatches.

    The errTasks workqueue analog (cache.go:687-709): per-item exponential
    backoff (AddRateLimited's ItemExponentialFailureRateLimiter shape),
    retries the SAME intent on later cycles without a fresh scheduling
    decision, and after ``max_attempts`` gives up and resyncs the task back
    to Pending (the syncTask refetch discovering the pod never bound)."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 10.0,
                 max_attempts: int = 15):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.max_attempts = max_attempts
        self.entries: List[dict] = []
        #: attempts-exhausted intents, kept (bounded by workload, not
        #: uptime: an intent dead-letters at most once) instead of being
        #: dropped silently — surfaced through METRICS
        #: ``resync_dead_letter_total`` and the flight recorder so an
        #: operator can see WHAT the scheduler gave up on, the way the
        #: reference's Forget + event log does
        self.dead: List[dict] = []

    def __len__(self) -> int:
        return len(self.entries)

    def add(self, intent, kind: str, now: float, attempts: int = 1) -> None:
        delay = min(self.base_delay * (2 ** (attempts - 1)), self.max_delay)
        self.entries.append(dict(intent=intent, kind=kind, attempts=attempts,
                                 next_try=now + delay))

    def dead_letter(self) -> List[dict]:
        """Copies of the attempts-exhausted entries (intent, kind,
        attempts, gave_up_at). Never mutated by later processing."""
        return [dict(e) for e in self.dead]

    def redrive(self, now: float = 0.0) -> int:
        """Dead letters back to pending with attempts reset — the second
        life a restart grants: the crash that stranded these intents also
        reset whatever condition exhausted their retries (a wedged node
        agent, a stale hold). Counted as ``resync_redrive_total``."""
        dead, self.dead = self.dead, []
        for e in dead:
            self.add(e["intent"], e["kind"], now, attempts=1)
        if dead:
            METRICS.inc("resync_redrive_total", len(dead))
            spans.log_event("resync_redrive", count=len(dead))
        return len(dead)

    def process(self, cluster, now: float,
                fence: Optional[int] = None) -> Dict[str, int]:
        """Retry every due entry against the cluster. Returns counters.
        An entry that exhausts ``max_attempts`` is never dropped silently:
        it moves to the dead-letter list (and a bind additionally resyncs
        the task back to Pending, the syncTask give-up). A ``fence`` that
        the cluster no longer admits (this replica was deposed) drops the
        due entries outright — a deposed leader must not keep retrying
        writes the fencing token already rejected."""
        due = [e for e in self.entries if e["next_try"] <= now]
        self.entries = [e for e in self.entries if e["next_try"] > now]
        stats = dict(retried=0, succeeded=0, dropped=0, dead_lettered=0,
                     fenced=0)
        for e in due:
            if fence is not None and not cluster.fence_admits(fence):
                stats["fenced"] += 1
                continue
            stats["retried"] += 1
            ok = ((cluster.bind(e["intent"], fence=fence)
                   if e["kind"] == "bind"
                   else cluster.evict(e["intent"], fence=fence))
                  if fence is not None
                  else (cluster.bind(e["intent"]) if e["kind"] == "bind"
                        else cluster.evict(e["intent"])))
            if ok:
                stats["succeeded"] += 1
            elif e["attempts"] >= self.max_attempts:
                stats["dropped"] += 1
                stats["dead_lettered"] += 1
                self.dead.append(dict(e, gave_up_at=now))
                if e["kind"] == "bind":
                    cluster.resync_task(e["intent"].task_uid)
            else:
                self.add(e["intent"], e["kind"], now, e["attempts"] + 1)
        return stats


class Scheduler:
    def __init__(self, cluster: FakeCluster,
                 conf: Optional[SchedulerConfiguration] = None,
                 conf_path: Optional[str] = None,
                 schedule_period: float = 1.0,
                 incremental: bool = True,
                 pipeline: Optional[bool] = None,
                 elector=None, device="cuda"):
        """``device``: where every Session of the loop runs, the card by
        default, ``"cpu"`` for the plain PyTorch versions of the kernels.
        ``pipeline=True`` (or conf ``pipeline: true``) and an ``elector``
        raise, naming their ROADMAP items."""
        if elector is not None:
            raise NotImplementedError(
                "leader election (elector) is not ported to "
                f"volcano_tpu_torch yet: {_SERVED}")
        self.cluster = cluster
        self.device = device
        self.conf_path = conf_path
        self._conf_mtime = 0.0
        self.conf = conf or self._load_conf() or parse_conf()
        # the mode is fixed here, as in the reference: the constructor's
        # argument overrides the conf, and a hot reload keeps the mode
        if (bool(getattr(self.conf, "pipeline", False)) if pipeline is None
                else bool(pipeline)):
            raise NotImplementedError(
                "the pipelined loop (conf pipeline: true, or "
                "pipeline=True) is not ported to volcano_tpu_torch yet: "
                f"{_NEXT_SLICE}")
        self.schedule_period = schedule_period
        self.cycles = 0
        self.resync = ResyncQueue()
        # the persistent session: built over the cluster's live view on the
        # first cycle, then re-opened each cycle through refresh_snapshot
        # from the cluster's dirty marks — the steady path that skips the
        # full repack. incremental=False gives every cycle a fresh Session
        # on a snapshot copy (the oracle of equality tests).
        self.incremental = incremental and hasattr(cluster, "live_view")
        self._session: Optional[Session] = None
        #: cycles that paid a full pack (first cycle, structural change, or
        #: a refresh fallback) vs cycles served by the incremental patch —
        #: the steady-state claim is checkable: full_packs stays at 1
        self.full_packs = 0
        self.incremental_cycles = 0
        #: (dirty job count, dirty node count) the last session open drained
        #: from the cluster, for the flight record beside upload_bytes
        self._last_dirty = (0, 0)
        #: bounded flight recorder: the last N cycle records (host
        #: timestamps, latency, bind/evict counts, upload bytes)
        self.flight = FlightRecorder(
            capacity=int(os.environ.get("VOLCANO_FLIGHT_CYCLES", 64)))

    def _load_conf(self) -> Optional[SchedulerConfiguration]:
        """Conf hot-reload (fsnotify watcher, scheduler.go:146-171 — here a
        cheap mtime poll at cycle start)."""
        if not self.conf_path or not os.path.exists(self.conf_path):
            return None
        mtime = os.path.getmtime(self.conf_path)
        if mtime == self._conf_mtime:
            return None
        self._conf_mtime = mtime
        with open(self.conf_path) as f:
            return parse_conf(f.read())

    def _open_session(self, now: Optional[float]) -> Session:
        """Open this cycle's session.

        Steady state holds ONE session across cycles and re-opens it with an
        incremental snapshot refresh fed by the cluster's dirty marks — the
        analog of the reference's incrementally maintained cache
        (event_handlers.go:43-740) feeding runOnce (scheduler.go:91). A full
        Session build (deep pack) happens only on the first cycle, on
        structural cluster changes, or when refresh_snapshot takes one of
        its documented repack fallbacks (then inside the same session).
        The reference also hands each session the plugins that keep state
        across cycles (reservation, tdm); neither is ported (ROADMAP item
        5b), so every session builds its own."""
        if not self.incremental:
            return Session(self.cluster.snapshot(), self.conf, now=now,
                           device=self.device)
        dj, dn, structural = self.cluster.drain_dirty()
        self._last_dirty = (len(dj), len(dn))
        ssn = self._session
        if ssn is None or structural:
            # a fresh full pack absorbs any dirty backlog
            ssn = Session(self.cluster.live_view(), self.conf, now=now,
                          device=self.device)
            self._session = ssn
            self.full_packs += 1
            return ssn
        for uid in dj:
            ssn._dirty_jobs.add(uid)
        for name in dn:
            ssn._dirty_nodes.add(name)
        if ssn.reopen(now=now, conf=self.conf):
            self.incremental_cycles += 1
        else:
            self.full_packs += 1
        return ssn

    def warmup(self, now: Optional[float] = None) -> None:
        """The reference's ahead-of-time compile of the allocate entry
        before the first cycle; it comes with the pipelined loop."""
        raise NotImplementedError(
            f"Scheduler.warmup is not ported to volcano_tpu_torch yet: "
            f"{_NEXT_SLICE}")

    def run_once(self, now: Optional[float] = None) -> Session:
        """One synchronous scheduling cycle (runOnce, scheduler.go:91-120):
        conf reload, the due resync retries, the session, the conf's
        actions, then the flush (:meth:`_finish_cycle`). Returns this
        cycle's Session. An exception in an action propagates, with
        nothing flushed."""
        reloaded = self._load_conf()
        if reloaded is not None:
            self.conf = reloaded
        t0 = time.time()
        wall = now if now is not None else t0
        actions = list(self.conf.actions)
        # drain due resync retries BEFORE snapshotting so the cycle sees
        # their outcomes (the errTasks worker runs alongside the loop,
        # cache.go:687-709)
        if len(self.resync):
            rs = self.resync.process(self.cluster, wall)
            METRICS.inc("resync_retried", rs["retried"])
            METRICS.inc("resync_succeeded", rs["succeeded"])
            METRICS.inc("resync_dropped", rs["dropped"])
            if rs["dead_lettered"]:
                METRICS.inc("resync_dead_letter_total", rs["dead_lettered"])
        with spans.span("cycle.open"):
            ssn = self._open_session(now)
        from ..actions import get_action
        for name in actions:
            ta = time.time()
            with spans.span(f"action.{name}"):
                get_action(name).execute(ssn)
            METRICS.observe_action(name, time.time() - ta)
        return self._finish_cycle(ssn, time.time() - t0, wall)

    def _finish_cycle(self, ssn: Session, host_s: float,
                      wall: float) -> Session:
        """Everything after the last action: close, write back, flush
        intents, metrics, flight record."""
        with spans.span("cycle.finish"):
            ssn.close()
            # PodGroup status write-back at session close (the jobUpdater's
            # parallel UpdatePodGroup flush, framework/job_updater.go:66-108)
            self.cluster.update_podgroup_phases(ssn.phase_updates)
            for intent in ssn.evictions:
                if not self.cluster.evict(intent):
                    METRICS.inc("resync_tasks")
                    self.resync.add(intent, "evict", wall)
            for intent in ssn.binds:
                if not self.cluster.bind(intent):
                    METRICS.inc("resync_tasks")
                    # hold the Binding state so later cycles don't
                    # re-decide while the rate-limited retry works
                    # (cache.go:549-560)
                    self.cluster.hold_binding(intent)
                    self.resync.add(intent, "bind", wall)
        METRICS.observe_cycle(host_s)
        METRICS.inc("schedule_attempts")
        # reference vocabulary: schedule_attempts_total{result=...}
        # (metrics.go:92-100 scheduleAttempts) — "error" when a bind
        # degraded to a recorded error, else by whether anything placed
        result = ("error" if ssn.bind_errors
                  else "scheduled" if (ssn.binds or ssn.pipelined)
                  else "unschedulable")
        METRICS.inc("schedule_attempts_total", labels={"result": result})
        spans.publish_gauges(METRICS)
        self.cycles += 1
        stats = ssn.stats
        if "mesh_devices" in stats:
            METRICS.set_gauge("mesh_width", None, int(stats["mesh_devices"]))
        kind = stats.get("last_kind")
        self.flight.record(
            now=wall, cycle=self.cycles, cycle_ms=round(host_s * 1000, 3),
            binds=len(ssn.binds), evictions=len(ssn.evictions),
            pipelined=len(ssn.pipelined), bind_errors=len(ssn.bind_errors),
            resync_pending=len(self.resync), result=result,
            # no recovered faults and rung 0: the sync loop has no ladder
            faults=None, degradation=0,
            resync_dead_letter=len(self.resync.dead),
            # what this cycle shipped against a full upload, and which
            # path it took ("full", "delta"; a recovery counts as full)
            cycle_kind=(None if kind is None
                        else "delta" if kind == "delta" else "full"),
            upload_bytes=stats.get("upload_bytes"),
            upload_bytes_full=stats.get("full_upload_bytes"),
            mesh_devices=(int(stats["mesh_devices"])
                          if "mesh_devices" in stats else None),
            resharding_copies=None,
            dirty_jobs=self._last_dirty[0], dirty_nodes=self._last_dirty[1],
            stats={k: round(float(v), 3) for k, v in stats.items()
                   if isinstance(v, (int, float))},
            telemetry=ssn.last_telemetry or None,
            # per-cycle span summary (plain {phase: ms} dict)
            spans=spans.drain_cycle_summary())
        return ssn

    def drain(self, now: Optional[float] = None):
        """Retire every in-flight pipelined cycle. The synchronous loop
        leaves none in flight: returns None."""
        return None

    def checkpoint(self, path: str, now: Optional[float] = None) -> dict:
        raise NotImplementedError(
            f"Scheduler.checkpoint is not ported to volcano_tpu_torch yet: "
            f"{_SERVED}")

    def checkpoint_state(self) -> tuple:
        raise NotImplementedError(
            "Scheduler.checkpoint_state is not ported to volcano_tpu_torch "
            f"yet: {_SERVED}")

    def restore(self, path: str, now: Optional[float] = None) -> str:
        raise NotImplementedError(
            f"Scheduler.restore is not ported to volcano_tpu_torch yet: "
            f"{_SERVED}")

    def run(self, cycles: int = 1, sleep: bool = False) -> List[Session]:
        out = []
        for _ in range(cycles):
            out.append(self.run_once())
            if sleep:
                time.sleep(self.schedule_period)
        return out
