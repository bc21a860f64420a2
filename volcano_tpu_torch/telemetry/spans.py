"""Host-side span tracing for the steady cycle (the port's copy of
``volcano_tpu/telemetry/spans.py``, standard library only).

A low-overhead monotonic-clock span API instrumenting the seams of the
steady cycle (scheduler open/actions/finish, session extras, dispatch,
readback, digest, unpack and apply, the delta kernel's pack, diff, upload
and dispatch), feeding three surfaces:

- **Latency rings.** Every completed span lands its duration in a bounded
  per-phase ring; :func:`phase_stats` serves p50/p95/p99 per phase.
- **Pipeline occupancy.** The owners of a pipelined loop record the
  in-flight DEVICE window (dispatch to drain) per cycle;
  :func:`occupancy` intersects the union of non-``wait`` host spans with
  those windows (``pipeline_overlap_fraction``, ``bubble_ms``). The
  synchronous loop records no window.
- **Exporters.** :func:`export_chrome_trace` emits Chrome trace-event
  JSON (Perfetto-loadable), and :func:`log_event` keeps a structured
  JSONL-ready event log of digest trips and recoveries (write-through to
  ``$VOLCANO_EVENT_LOG`` when set).

Spans are HOST-ONLY: nothing here touches a kernel or a tensor, so the
decisions are the same with tracing on or off. A disabled ``span()``
returns a shared no-op context; an enabled one costs two
``perf_counter`` reads and one deque append under a lock.
``VOLCANO_SPANS=0`` disables at import.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Optional

_ENABLED = os.environ.get("VOLCANO_SPANS", "1").lower() not in (
    "0", "false", "off")

#: bounded buffers — memory is O(cap), never O(uptime)
_MAX_EVENTS = int(os.environ.get("VOLCANO_SPAN_EVENTS", 8192))
_RING = int(os.environ.get("VOLCANO_SPAN_RING", 512))
_MAX_LOG = int(os.environ.get("VOLCANO_EVENT_LOG_CAP", 1024))

#: device-window events ride a dedicated trace track (tid) per shard so
#: Perfetto renders them as their own lane under the host threads
_DEVICE_TID = 900

_LOCK = threading.Lock()
_EVENTS: deque = deque(maxlen=_MAX_EVENTS)
_PHASES: Dict[str, deque] = defaultdict(lambda: deque(maxlen=_RING))
#: fleet: per-(tenant, phase) duration rings, fed by the fleet
#: scheduler's per-tenant cycle accounting — the SLO latency surface cut
#: by tenant, same bounded-memory rule as the global rings
_TENANT_PHASES: Dict[tuple, deque] = defaultdict(
    lambda: deque(maxlen=_RING))
_CYCLE_ACC: Dict[str, float] = defaultdict(float)
_EVENT_LOG: deque = deque(maxlen=_MAX_LOG)
_TIDS: Dict[int, int] = {}
_TID_NAMES: Dict[int, str] = {}

#: one monotonic epoch per process; the wall anchor lets exporters (and a
#: device-trace merge) map span timestamps back to wall time
_T0 = time.perf_counter()
_WALL0 = time.time()


def now() -> float:
    """Seconds on the span clock (monotonic, process epoch)."""
    return time.perf_counter() - _T0


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip tracing at runtime (tests; ops kill-switch). Returns the
    previous state. Buffers are kept — call :func:`reset` to drop them."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


def _tid() -> int:
    ident = threading.get_ident()
    t = _TIDS.get(ident)
    if t is None:
        with _LOCK:
            t = _TIDS.setdefault(ident, len(_TIDS) + 1)
            _TID_NAMES.setdefault(t, threading.current_thread().name)
    return t


class _NullSpan:
    """The disabled-path singleton: a no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "t0")

    def __init__(self, name: str, cat: str, args):
        self.name = name
        self.cat = cat
        self.args = args or None
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter() - _T0
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter() - _T0
        dur = t1 - self.t0
        tid = _tid()
        ms = dur * 1000.0
        with _LOCK:
            _EVENTS.append({"name": self.name, "cat": self.cat,
                            "ts": self.t0, "dur": dur, "tid": tid,
                            "args": self.args})
            _PHASES[self.name].append(ms)
            _CYCLE_ACC[self.name] += ms
        return False


def span(name: str, cat: str = "host", **args):
    """A nestable, thread-aware timing span: ``with span("pack"): ...``.

    ``cat`` tags the occupancy treatment: ``"wait"`` marks time the host
    is BLOCKED (device readback, ``block_until_ready``) — subtracted from
    the host-work union so a synchronous loop honestly reports ~zero
    pipeline overlap; ``"device"`` is reserved for device windows. Any
    other category counts as host work."""
    if not _ENABLED:
        return _NULL
    return _Span(name, cat, args)


def device_window(t0: float, t1: float, shard: Optional[int] = None,
                  shards: int = 1, **args) -> None:
    """Record one cycle's in-flight DEVICE window (dispatch→drain), in
    span-clock seconds (:func:`now`). The window deliberately runs to the
    DRAIN, not to device completion — it is the interval the pipeline has
    available for host/device overlap, which is what the occupancy
    analyzer prices. With ``shards > 1`` the single GSPMD launch covers
    every shard, so one call records the common window; pass ``shard=``
    if a path ever gets genuinely per-shard windows."""
    if not _ENABLED:
        return
    dur = max(float(t1) - float(t0), 0.0)
    a = dict(args)
    if shards and shards > 1:
        a["shards"] = int(shards)
    with _LOCK:
        _EVENTS.append({"name": "device_window", "cat": "device",
                        "ts": float(t0), "dur": dur,
                        "tid": _DEVICE_TID + (shard or 0),
                        "shard": shard, "shards": int(shards or 1),
                        "args": a or None})
        _PHASES["device.window"].append(dur * 1000.0)


# --------------------------------------------------------------- accessors
def _pct(sorted_vals: List[float], q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(round(q * (len(sorted_vals) - 1))))]


def phase_stats() -> Dict[str, Dict[str, float]]:
    """{phase: {count, p50, p95, p99, mean, last, total_ms}} over each
    phase's duration ring (ms) — the SLO latency surface."""
    with _LOCK:
        rings = {k: list(v) for k, v in _PHASES.items() if v}
    out = {}
    for k in sorted(rings):
        vals = rings[k]
        s = sorted(vals)
        out[k] = {"count": len(s),
                  "p50": round(_pct(s, 0.50), 3),
                  "p95": round(_pct(s, 0.95), 3),
                  "p99": round(_pct(s, 0.99), 3),
                  "mean": round(sum(s) / len(s), 3),
                  "last": round(vals[-1], 3),
                  "total_ms": round(sum(s), 3)}
    return out


def record_tenant_phase(tenant: str, phase: str, ms: float) -> None:
    """Land one per-tenant phase duration (ms) in the tenant's ring.
    Called by the fleet scheduler per served tenant per cycle; a plain
    deque append, so the fleet loop pays the same O(1) the global rings
    cost."""
    if not _ENABLED:
        return
    with _LOCK:
        _TENANT_PHASES[(str(tenant), str(phase))].append(float(ms))


def tenant_phase_stats() -> Dict[str, Dict[str, Dict[str, float]]]:
    """{tenant: {phase: {count, p50, p95, p99, mean, last}}} over the
    per-tenant duration rings — :func:`phase_stats` cut by tenant."""
    with _LOCK:
        rings = {k: list(v) for k, v in _TENANT_PHASES.items() if v}
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for (tenant, phase) in sorted(rings):
        vals = rings[(tenant, phase)]
        s = sorted(vals)
        out.setdefault(tenant, {})[phase] = {
            "count": len(s),
            "p50": round(_pct(s, 0.50), 3),
            "p95": round(_pct(s, 0.95), 3),
            "p99": round(_pct(s, 0.99), 3),
            "mean": round(sum(s) / len(s), 3),
            "last": round(vals[-1], 3)}
    return out


def drain_cycle_summary() -> Optional[Dict[str, float]]:
    """Per-phase ms accumulated since the last drain, then reset — the
    flight-recorder's per-cycle span summary (plain floats: JSON- and
    pickle-safe by construction). Under the one-deep pipeline a cycle's
    summary covers the host work performed during ITS run_once, which
    mixes the tail of the previous cycle's drain — that is the honest
    attribution of what the loop actually paid that turn."""
    with _LOCK:
        if not _CYCLE_ACC:
            return None
        acc = {k: round(v, 3) for k, v in _CYCLE_ACC.items()}
        _CYCLE_ACC.clear()
    return acc


def events() -> List[dict]:
    """Copies of the structured event log entries (oldest first)."""
    with _LOCK:
        return [dict(e) for e in _EVENT_LOG]


def log_event(kind: str, **fields) -> Optional[dict]:
    """Append one structured event (degradation transition, digest trip,
    recovery; the scenario engine's per-cycle ``scenario_cycle`` and
    end-of-run ``scenario_done`` quality records) to the bounded log;
    write-through as one JSON line to ``$VOLCANO_EVENT_LOG`` when set
    (best-effort — the log must never take the cycle down)."""
    if not _ENABLED:
        return None
    entry = dict(fields)
    entry["kind"] = kind
    entry["ts_ms"] = round(now() * 1000.0, 3)
    entry["wall_ts"] = round(_WALL0 + entry["ts_ms"] / 1000.0, 6)
    with _LOCK:
        _EVENT_LOG.append(entry)
    path = os.environ.get("VOLCANO_EVENT_LOG")
    if path:
        try:
            with open(path, "a") as f:
                f.write(json.dumps(entry, default=str) + "\n")
        except OSError:
            pass
    return entry


# --------------------------------------------------------------- occupancy
def _merge(iv: List[tuple]) -> List[tuple]:
    """Coalesce [start, end) intervals into a sorted disjoint union."""
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _subtract(a: List[tuple], b: List[tuple]) -> List[tuple]:
    """Disjoint-union ``a`` minus disjoint-union ``b``."""
    out = []
    for s, e in a:
        cur = s
        for bs, be in b:
            if be <= cur or bs >= e:
                continue
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def _window_depth(w: dict) -> int:
    """Pipeline depth a device window was dispatched under (args tag from
    the session/sidecar drain; pre-depth events count as 1)."""
    try:
        return int((w.get("args") or {}).get("depth") or 1)
    except (TypeError, ValueError):
        return 1


def compute_occupancy(evts: Iterable[dict]) -> Dict[str, object]:
    """Pure occupancy math over span/window event dicts (unit-testable on
    synthetic inputs). Host work is computed PER THREAD — each thread's
    non-``wait``/non-``device`` span union minus its own ``wait`` union —
    then unioned across threads: the async pack worker's real work counts
    as overlap even while the main thread blocks in a drain, and one
    thread's wait never blanks another thread's work (the global merge
    the pre-depth analyzer did). Nesting never double-counts, and an
    outer span covering a blocked readback doesn't masquerade as overlap
    (the synchronous loop's window is ~all wait, so it honestly reports
    ~0). For each device window: ``overlap`` is the host-work time inside
    it, ``bubble`` the remainder. Windows tagged with a dispatch
    ``depth`` additionally group into ``per_depth`` (the depth-k
    acceptance surface: overlap fraction reported per pipeline depth)."""
    evts = list(evts)
    windows = [e for e in evts if e.get("cat") == "device"]
    host_by_tid: Dict[object, list] = {}
    wait_by_tid: Dict[object, list] = {}
    for e in evts:
        cat = e.get("cat")
        if cat == "device":
            continue
        dst = wait_by_tid if cat == "wait" else host_by_tid
        dst.setdefault(e.get("tid", 0), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    busy = _merge([iv for tid, host in host_by_tid.items()
                   for iv in _subtract(_merge(host),
                                       _merge(wait_by_tid.get(tid, [])))])

    def analyze(ws):
        w_s = o_s = 0.0
        for w in ws:
            a, b = w["ts"], w["ts"] + w["dur"]
            w_s += b - a
            o_s += sum(min(b, e) - max(a, s)
                       for s, e in busy if e > a and s < b)
        return {"windows": len(ws),
                "window_ms": round(w_s * 1000.0, 3),
                "overlap_ms": round(o_s * 1000.0, 3),
                "bubble_ms": round((w_s - o_s) * 1000.0, 3),
                "pipeline_overlap_fraction":
                    (round(o_s / w_s, 4) if w_s > 0 else None)}

    out = analyze(windows)
    shard_ids = sorted({w.get("shard") for w in windows
                        if w.get("shard") is not None})
    n_shards = max([int(w.get("shards") or 1) for w in windows], default=1)
    per_shard = None
    if shard_ids or n_shards > 1:
        ids = shard_ids or list(range(n_shards))
        # a shard=None window is the common GSPMD launch: it covers every
        # shard, so it contributes to each shard's view
        per_shard = {str(s): analyze([w for w in windows
                                      if w.get("shard") in (None, s)])
                     for s in ids}
    out["per_shard"] = per_shard
    depths = sorted({_window_depth(w) for w in windows})
    out["per_depth"] = (
        {str(d): analyze([w for w in windows if _window_depth(w) == d])
         for d in depths}
        if depths and depths != [1] else None)
    return out


def occupancy() -> Dict[str, object]:
    """Occupancy analysis over the live event ring: how much of the
    in-flight device windows the host covered with real (non-wait) work,
    aggregate, per shard, and per pipeline depth, tagged with the torch
    backend the windows ran on ("cuda" when a card is visible)."""
    with _LOCK:
        evts = [dict(e) for e in _EVENTS]
    out = compute_occupancy(evts)
    import torch
    out["backend"] = "cuda" if torch.cuda.is_available() else "cpu"
    return out


# --------------------------------------------------------------- exporters
def export_chrome_trace(path: Optional[str] = None,
                        merge=None) -> Dict[str, object]:
    """The span + device-window rings as Chrome trace-event JSON
    (Perfetto / chrome://tracing loadable): complete ("X") events in
    microseconds on the span clock, with thread/track-name metadata.
    ``merge`` accepts another trace dict or a path to one (e.g. a
    converted ``torch.profiler`` device trace) whose ``traceEvents`` are
    appended under their own pid. Writes to ``path`` when given; returns
    the trace dict either way."""
    with _LOCK:
        evts = [dict(e) for e in _EVENTS]
        tid_names = dict(_TID_NAMES)
        log = [dict(e) for e in _EVENT_LOG]
    tev: List[dict] = [{"name": "process_name", "ph": "M", "pid": 1,
                        "args": {"name": "volcano_tpu_torch host"}}]
    device_tids = {}
    for e in evts:
        ev = {"name": e["name"], "cat": e["cat"], "ph": "X",
              "ts": round(e["ts"] * 1e6, 3), "dur": round(e["dur"] * 1e6, 3),
              "pid": 1, "tid": e["tid"]}
        if e.get("args"):
            ev["args"] = e["args"]
        if e.get("cat") == "device":
            shard = e.get("shard")
            device_tids[e["tid"]] = ("device" if shard is None
                                     else f"device shard {shard}")
        tev.append(ev)
    # degradation / digest-trip / recovery events as instants on track 0
    for e in log:
        tev.append({"name": e.get("kind", "event"), "cat": "event",
                    "ph": "i", "s": "p",
                    "ts": round(e.get("ts_ms", 0.0) * 1e3, 3),
                    "pid": 1, "tid": 0,
                    "args": {k: v for k, v in e.items()
                             if k not in ("ts_ms",)}})
    for tid, name in tid_names.items():
        tev.append({"name": "thread_name", "ph": "M", "pid": 1,
                    "tid": tid, "args": {"name": name}})
    for tid, name in device_tids.items():
        tev.append({"name": "thread_name", "ph": "M", "pid": 1,
                    "tid": tid, "args": {"name": name}})
    trace = {"traceEvents": tev, "displayTimeUnit": "ms",
             "otherData": {"clock": "perf_counter",
                           "wall_epoch": round(_WALL0, 6)}}
    if merge is not None:
        try:
            if isinstance(merge, str):
                with open(merge) as f:
                    merge = json.load(f)
            extra = merge.get("traceEvents", merge) \
                if isinstance(merge, dict) else merge
            trace["traceEvents"] = list(trace["traceEvents"]) + list(extra)
        except Exception:  # merge is best-effort, never fatal
            pass
    if path:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def export_event_log(path: str) -> int:
    """Dump the structured event log as JSONL; returns the line count."""
    entries = events()
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e, default=str) + "\n")
    return len(entries)


def publish_gauges(metrics=None, include_occupancy: bool = False) -> None:
    """Export the phase rings as ``span_phase_ms{phase=...,q=...}`` gauges
    (and, when asked, the occupancy numbers) into the METRICS registry.
    Occupancy is opt-in because it scans the whole event ring — the
    per-cycle scheduler publish sticks to the cheap phase stats; bench,
    the CLI, and the dashboard ask for the full picture."""
    if metrics is None:
        from ..metrics import METRICS as metrics
    for phase, st in phase_stats().items():
        for q in ("p50", "p95", "p99"):
            metrics.set_gauge("span_phase_ms",
                              {"phase": phase, "q": q}, st[q])
    for tenant, phases in tenant_phase_stats().items():
        for phase, st in phases.items():
            for q in ("p50", "p95", "p99"):
                metrics.set_gauge("span_phase_ms",
                                  {"phase": phase, "q": q,
                                   "tenant": tenant}, st[q])
    if include_occupancy:
        occ = occupancy()
        if occ.get("pipeline_overlap_fraction") is not None:
            metrics.set_gauge("pipeline_overlap_fraction", None,
                              occ["pipeline_overlap_fraction"])
            metrics.set_gauge("pipeline_bubble_ms", None, occ["bubble_ms"])


def reset() -> None:
    """Drop every buffer (tests / bench isolation). Thread-id mappings
    are kept — they are stable identities, not measurements."""
    with _LOCK:
        _EVENTS.clear()
        _PHASES.clear()
        _TENANT_PHASES.clear()
        _CYCLE_ACC.clear()
        _EVENT_LOG.clear()
