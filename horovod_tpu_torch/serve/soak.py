"""Serving SLO soaks: prove bad days are survivable, don't claim it.

The port of ``horovod_tpu/serve/soak.py`` — the acceptance harness of
the whole serving plane. ``run_serve_soak`` stands up an N-replica
:class:`~horovod_tpu_torch.serve.fleet.FleetRouter` over a tiny
decode-mode GPT, drives CLOSED-LOOP synthetic traffic at a fixed offered
load (``clients`` concurrent requesters, each with at most one request
outstanding), and fires a seeded serve-profile chaos plan at it — one
replica crashed mid-decode, a second partitioned from the router, a KV
block corrupted, one replica slowed past the suspect threshold, one
admission dropped at the queue door — while a training-side
:class:`~horovod_tpu_torch.redist.stream.WeightPublisher` pushes a fresh
weight version mid-incident. The verdict (a JSON-able dict) asserts:

* **zero silent drops** — every submitted request reached a terminal
  state, and every shed/rejected answer carries ``retry_after_ms``;
* **at-most-once** — no request was answered twice;
* **KV containment** — the injected cache corruption was caught by the
  crc ledger (``detected >= injected > 0``);
* **bounded failover** — the crashed replica was ejected within
  ``2 x suspect_s`` of the crash;
* **SLO held outside recovery windows** — p99 latency and error rate
  of requests that do not overlap any fault's recovery window stay
  under the declared bounds;
* **capacity restored on fresh weights** — the fleet ends with every
  replica up and serving the NEWEST published weight version.

The ``evaluate_*`` functions are the pure records -> verdict cores, with
the reference's verdict keys. ``run_fleet_soak`` (replica worker
processes behind a ``ProcessFleetRouter``), ``run_disagg_soak`` (prefill
and decode pools behind a ``DisaggRouter``, traced) and
``run_kvtier_soak`` (the fleet KV tier) are the siblings.
``run_autoscale_soak`` waits for ``autoscale/`` (``ROADMAP.md`` item
13); its verdict, :func:`evaluate_autoscale`, is here.

Where the weights come from: the reference derives the soak's weights
from a seed with ``jax.random`` in every process; the port's
``serve.worker.tiny_gpt_builder`` draws them with ``init_gpt_params``
from a ``torch.Generator`` seeded on the builder's device, so every
worker process and the publisher hold the same bits (the same
distributions as the reference's, not the same numbers). Every runner
takes ``device`` (None: the card, raising without CUDA; ``"cpu"`` runs
the plain versions, as the tests do).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger("horovod_tpu_torch")

DEFAULT_REPLICAS = 3
DEFAULT_CLIENTS = 6
DEFAULT_STEPS = 240          # scheduler-iteration horizon the plan lands in
DEFAULT_SUSPECT_S = 1.0
DEFAULT_INTERVAL_S = 0.25
DEFAULT_SLO_P99_MS = 15000.0
DEFAULT_SLO_ERROR_RATE = 0.02
DEFAULT_RECOVERY_WINDOW_S = 6.0
#: disruptions that open a recovery window in the SLO evaluation
_DISRUPTIVE = ("crash", "slow_rank", "partition", "corrupt", "drop",
               "delay")
#: the PROCESS-fleet soak's default suspect threshold: heartbeats now
#: cross a real process boundary, and on a small/oversubscribed box
#: (CI runs this on 2 cores) two worker processes can co-stall past
#: 1 s without either being dead — a margin that tight turns scheduler
#: hiccups into unscheduled failovers the verdict rightly refuses to
#: call green. 2 s keeps detection O(heartbeat) (bound 2x = 4 s) while
#: staying honest about what a loaded host can promise.
FLEET_SUSPECT_S = 2.0


def _resolve_plan(plan, seed: int, replicas: int, steps: int):
    from ..chaos.plan import ChaosPlan, random_plan
    if plan is None or plan == "random":
        return random_plan(seed, replicas, steps, profile="serve")
    if isinstance(plan, ChaosPlan):
        return plan
    return ChaosPlan.parse(str(plan))



def _windows_closed(events: List[dict], recovery_window_s: float,
                    dwell_s: float) -> bool:
    """Has every recovery window (a disruptive chaos fault's or an
    ejection's, as the verdicts open them) been closed for ``dwell_s``?
    The SLO is judged on requests outside every window, so the runners
    keep offering load past the last one: on a fast card the whole plan
    lands in a second or two, and stopping at the dwell after recovery
    would leave no request outside the windows."""
    now = time.time()
    return all(now >= e["t"] + recovery_window_s + dwell_s for e in events
               if (e.get("kind") == "chaos"
                   and e.get("fault") in _DISRUPTIVE)
               or (e.get("kind") == "fleet"
                   and e.get("event") == "eject"))


def evaluate_serve(records: List[dict], events: List[dict], plan,
                   fleet_stats: dict, *, replicas: int,
                   suspect_s: float, slo_p99_ms: float,
                   slo_error_rate: float, recovery_window_s: float,
                   newest_version: Optional[int],
                   kv_injected: int, kv_detected: int) -> dict:
    """Pure records->verdict core. ``records`` is one dict per client
    request ({fid, t0, t1, status, retry_after_ms, latency_ms,
    resolutions}); ``events`` mixes injector ({kind: "chaos", ...})
    and router ({kind: "fleet", event: eject/readmit, ...}) entries,
    each with a wall-clock ``t``."""
    v: Dict[str, Any] = {
        "submitted": len(records),
        "statuses": {},
        "no_silent_drops": None, "answered_once": None,
        "shed_carry_retry_after": None, "kv_containment": None,
        "failover_bounded": None, "failover_s": None,
        "slo_held": None, "p99_outside_ms": None,
        "error_rate_outside": None, "clean_ok_samples": None,
        "capacity_restored": None, "victim": None,
        "kv_injected": kv_injected, "kv_detected": kv_detected,
        "duplicates_suppressed":
            fleet_stats.get("duplicates_suppressed", 0),
    }
    statuses: Dict[str, int] = {}
    for r in records:
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    v["statuses"] = statuses

    # -- zero silent drops: every request reached a terminal state
    v["no_silent_drops"] = (
        len(records) > 0
        and all(r["status"] != "pending" for r in records)
        and fleet_stats.get("inflight", 0) == 0)

    # -- at-most-once: no handle resolved twice
    v["answered_once"] = all(r.get("resolutions", 1) <= 1
                             for r in records)

    # -- every shed/rejected answer carries a retry hint
    shed = [r for r in records if r["status"] in ("shed", "rejected")]
    v["shed_carry_retry_after"] = all(
        (r.get("retry_after_ms") or 0) > 0 for r in shed)

    # -- KV containment: the scheduled corruption actually flipped
    # bytes AND the crc caught it (a plan that schedules a corrupt
    # which never lands proves nothing — fail, don't skip). Keyed on
    # the serve.kv site: a serve.migrate corrupt is the DISAGG soak's
    # business (evaluate_disagg migrate_corrupt_caught), not this
    # counter pair's.
    has_corrupt = any(f.kind == "corrupt" and f.site == "serve.kv"
                      for f in plan.faults)
    if has_corrupt:
        v["kv_containment"] = kv_injected > 0 and \
            kv_detected >= kv_injected
    # requests must never carry garbage: an "ok" that raced a detected
    # corruption is impossible by construction (verify-before-resolve),
    # so the evidence is the counter pair above.

    # -- bounded failover for the crashed replica
    crash = next((f for f in plan.faults if f.kind == "crash"), None)
    if crash is not None:
        v["victim"] = crash.peer
        t_crash = next((e["t"] for e in events
                        if e.get("kind") == "chaos"
                        and e.get("fault") == "crash"), None)
        t_eject = next((e["t"] for e in events
                        if e.get("kind") == "fleet"
                        and e.get("event") == "eject"
                        and e.get("replica") == crash.peer
                        and (t_crash is None or e["t"] >= t_crash)),
                       None)
        if t_crash is None or t_eject is None:
            v["failover_bounded"] = False   # never exercised: fail
        else:
            v["failover_s"] = round(t_eject - t_crash, 3)
            v["failover_bounded"] = \
                v["failover_s"] <= 2 * suspect_s

    # -- SLO outside recovery windows
    windows = [(e["t"], e["t"] + recovery_window_s) for e in events
               if e.get("kind") == "chaos"
               and e.get("fault") in _DISRUPTIVE]
    # an ejection's repair tail counts as disruption too (restart +
    # rewarm of the victim)
    windows += [(e["t"], e["t"] + recovery_window_s) for e in events
                if e.get("kind") == "fleet"
                and e.get("event") == "eject"]

    def outside(r):
        return not any(r["t0"] < hi and r["t1"] > lo
                       for lo, hi in windows)

    clean = [r for r in records if outside(r)]
    oks = sorted(r["latency_ms"] for r in clean
                 if r["status"] == "ok"
                 and r.get("latency_ms") is not None)
    v["clean_ok_samples"] = len(oks)
    served = [r for r in clean
              if r["status"] not in ("shed", "rejected")]
    errs = [r for r in served if r["status"] in ("error", "expired")]
    if len(oks) >= 20:
        # nearest-rank p99 over the outside-window completions
        v["p99_outside_ms"] = round(
            oks[min(len(oks) - 1, int(0.99 * len(oks)))], 1)
        v["error_rate_outside"] = round(
            len(errs) / max(len(served), 1), 4)
        v["slo_held"] = (v["p99_outside_ms"] <= slo_p99_ms
                         and v["error_rate_outside"] <= slo_error_rate)
    else:
        v["slo_held"] = False   # too few clean samples to claim an SLO

    # -- capacity restored on fresh weights
    versions = [r.get("weights_version")
                for r in fleet_stats.get("replicas", {}).values()]
    readmitted = (crash is None or any(
        e.get("kind") == "fleet" and e.get("event") == "readmit"
        and e.get("replica") == crash.peer for e in events))
    v["capacity_restored"] = (
        fleet_stats.get("replicas_up") == replicas
        and readmitted
        and newest_version is not None
        and all(ver == newest_version for ver in versions))

    v["ok"] = all(v[k] is not False for k in (
        "no_silent_drops", "answered_once", "shed_carry_retry_after",
        "kv_containment", "failover_bounded", "slo_held",
        "capacity_restored"))
    return v


def evaluate_fleet(records: List[dict], events: List[dict], plan,
                   fleet_stats: dict, *, replicas: int,
                   suspect_s: float, slo_p99_ms: float,
                   slo_error_rate: float, recovery_window_s: float,
                   newest_version: Optional[int],
                   dispatch_absorbed: int,
                   dedupe_hits: int) -> dict:
    """The MULTI-PROCESS fleet verdict: everything
    :func:`evaluate_serve` asserts (no silent drops, answered-once,
    shed-carries-retry-after, bounded failover, SLO outside recovery
    windows, capacity restored on the newest weights), plus the
    process-boundary invariants:

    * **blips_absorbed** — the scheduled ``serve.dispatch``
      ``conn_reset``/``flaky`` blips were absorbed by the retry ladder
      (``hvd_net_retries_total{site="serve.dispatch",
      outcome="absorbed"}`` > 0) …
    * **failovers_only_kills** — … and triggered ZERO failovers: the
      fleet's failover count equals exactly the number of SCHEDULED
      process kills. A blip that escalated into an ejection fails
      this.
    * **replays_deduped** — a ``conn_reset`` severs the dispatch
      socket AFTER the request frame was sent, so its ladder replay
      MUST have been served the worker's deduped result (worker
      ``dedupe_hits`` > 0): the evidence that a lost reply never
      became a duplicate execution.
    * **respawned_on_newest** — the killed replica's re-admission
      event carries the newest published weight version (the respawn
      weight gate actually gated).
    """
    v = evaluate_serve(
        records, events, plan, fleet_stats, replicas=replicas,
        suspect_s=suspect_s, slo_p99_ms=slo_p99_ms,
        slo_error_rate=slo_error_rate,
        recovery_window_s=recovery_window_s,
        newest_version=newest_version, kv_injected=0, kv_detected=0)
    kills = [f for f in plan.faults if f.kind == "crash"]
    blips = [f for f in plan.faults
             if f.site == "serve.dispatch"
             and f.kind in ("conn_reset", "flaky")]
    v["dispatch_absorbed"] = int(dispatch_absorbed)
    v["dedupe_hits"] = int(dedupe_hits)
    v["respawns"] = fleet_stats.get("respawns", 0)
    if blips:
        v["blips_absorbed"] = dispatch_absorbed > 0
    v["failovers_only_kills"] = \
        fleet_stats.get("failovers", 0) == len(kills)
    if any(f.kind == "conn_reset" for f in blips):
        v["replays_deduped"] = dedupe_hits > 0
    if kills:
        victim = kills[0].peer
        readmit = next((e for e in events
                        if e.get("kind") == "fleet"
                        and e.get("event") == "readmit"
                        and e.get("replica") == victim), None)
        v["respawned_on_newest"] = (
            readmit is not None and newest_version is not None
            and readmit.get("weights_version") == newest_version)
    v["ok"] = all(v.get(k) is not False for k in (
        "ok", "blips_absorbed", "failovers_only_kills",
        "replays_deduped", "respawned_on_newest"))
    return v


def evaluate_disagg(records: List[dict], events: List[dict], plan,
                    fleet_stats: dict, *, replicas: int,
                    suspect_s: float, slo_p99_ms: float,
                    slo_error_rate: float, recovery_window_s: float,
                    newest_version: Optional[int],
                    migrations_in: int, migrate_absorbed: int,
                    migrate_corrupt_detected: int,
                    reprefills: int,
                    traces: Optional[List[dict]] = None,
                    trace_slow_ms: float = 2000.0) -> dict:
    """The DISAGGREGATED-fleet verdict: everything
    :func:`evaluate_serve` asserts (no silent drops, answered-once,
    shed-carries-retry-after, bounded failover for the SIGKILLed
    prefill worker, SLO outside recovery windows, capacity restored on
    the newest weights), plus the migration-plane invariants:

    * **migrations_ok** — KV-block migration actually carried traffic
      (decode-pool installs > 0): a soak where every request happened
      to resolve at prefill proves nothing about the new plane.
    * **migrate_corrupt_caught** — the scheduled ``serve.migrate``
      ``corrupt`` (one payload bit flipped BEFORE framing, so the
      frame crc passes) was caught by the per-BLOCK crc ledger on
      arrival, before any token could be generated from the blocks.
    * **migrate_blips_recovered** — the scheduled ``conn_reset``
      (socket severed AFTER the kv_install frame landed) was survived:
      either the push ladder's replay was served the decode endpoint's
      deduped install ack (``migrate_absorbed`` > 0), or the request
      re-prefilled exactly once (``reprefills`` counts stay bounded by
      the at-most-once bookkeeping either way).
    * **failovers_only_kills** — pool ejections equal exactly the
      scheduled process kills: neither migration chaos kind may
      escalate into an ejection.
    * **respawned_on_newest** — the killed prefill worker re-admitted
      on the newest published weight version.
    * **traces_complete** (only when ``traces`` — the tracer's
      retained set — is passed, back-compat None skips it) — every
      interesting request the CLIENTS saw (errored / expired /
      async-shed / slower than ``trace_slow_ms``) has a retained
      trace under its fid; every synchronous front-door shed has a
      rid-less ``shed`` trace; and ≥99% of retained traces' leg
      decomposition tiles the router-measured e2e within 5% (the
      tiling error is the clock-alignment error — docs/tracing.md).
    """
    v = evaluate_serve(
        records, events, plan, fleet_stats, replicas=replicas,
        suspect_s=suspect_s, slo_p99_ms=slo_p99_ms,
        slo_error_rate=slo_error_rate,
        recovery_window_s=recovery_window_s,
        newest_version=newest_version, kv_injected=0, kv_detected=0)
    kills = [f for f in plan.faults if f.kind == "crash"]
    v["migrations_in"] = int(migrations_in)
    v["migrate_absorbed"] = int(migrate_absorbed)
    v["migrate_corrupt_detected"] = int(migrate_corrupt_detected)
    v["reprefills"] = int(reprefills)
    v["respawns"] = fleet_stats.get("respawns", 0)
    v["migrations_ok"] = migrations_in > 0
    if any(f.site == "serve.migrate" and f.kind == "corrupt"
           for f in plan.faults):
        v["migrate_corrupt_caught"] = migrate_corrupt_detected > 0
    if any(f.site == "serve.migrate" and f.kind == "conn_reset"
           for f in plan.faults):
        v["migrate_blips_recovered"] = (migrate_absorbed > 0
                                        or reprefills > 0)
    v["failovers_only_kills"] = \
        fleet_stats.get("failovers", 0) == len(kills)
    if kills:
        victim = kills[0].peer
        readmit = next((e for e in events
                        if e.get("kind") == "fleet"
                        and e.get("event") == "readmit"
                        and e.get("replica") == victim), None)
        v["respawned_on_newest"] = (
            readmit is not None and newest_version is not None
            and readmit.get("weights_version") == newest_version)
    if traces is not None:
        by_rid: Dict[object, List[dict]] = {}
        for t in traces:
            if t.get("rid") is not None:
                by_rid.setdefault(t["rid"], []).append(t)
        interesting = missing = 0
        for r in records:
            if r.get("fid") is None:
                continue
            slow = (r.get("latency_ms") is not None
                    and float(r["latency_ms"]) >= float(trace_slow_ms))
            if r.get("status") in ("error", "expired", "rejected") \
                    or slow:
                interesting += 1
                if r["fid"] not in by_rid:
                    missing += 1
        sync_sheds = sum(1 for r in records
                         if r.get("fid") is None
                         and r.get("status") == "shed")
        shed_traces = sum(1 for t in traces
                          if t.get("rid") is None
                          and t.get("status") == "shed")
        checked = bad = 0
        for t in traces:
            e2e, legs = t.get("e2e_ms"), t.get("legs_ms") or {}
            if e2e is None or not legs or float(e2e) <= 0.0:
                continue
            checked += 1
            if abs(sum(legs.values()) - float(e2e)) \
                    > 0.05 * float(e2e):
                bad += 1
        v["traces_retained"] = len(traces)
        v["traces_interesting"] = interesting
        v["traces_missing"] = missing
        v["trace_sync_sheds"] = sync_sheds
        v["trace_shed_traces"] = shed_traces
        v["trace_legs_checked"] = checked
        v["trace_leg_mismatches"] = bad
        v["traces_complete"] = (
            missing == 0
            and (sync_sheds == 0 or shed_traces >= sync_sheds)
            and (checked == 0 or (checked - bad) / checked >= 0.99))
    v["ok"] = all(v.get(k) is not False for k in (
        "ok", "migrations_ok", "migrate_corrupt_caught",
        "migrate_blips_recovered", "failovers_only_kills",
        "respawned_on_newest", "traces_complete"))
    return v


def run_disagg_soak(out_dir: Optional[str] = None, *,
                    prefill: int = 2,
                    decode: int = 1,
                    clients: int = 4,
                    seed: int = 0, plan=None,
                    steps: int = DEFAULT_STEPS,
                    suspect_s: float = FLEET_SUSPECT_S,
                    interval_s: float = DEFAULT_INTERVAL_S,
                    slo_p99_ms: float = DEFAULT_SLO_P99_MS,
                    slo_error_rate: float = DEFAULT_SLO_ERROR_RATE,
                    recovery_window_s: float = 8.0,
                    min_duration_s: float = 8.0,
                    max_duration_s: float = 180.0,
                    max_new_tokens: int = 8,
                    deadline_ms: float = 20000.0,
                    spec_k: int = 0,
                    kv_crc: Optional[bool] = None,
                    prefix_cache: Optional[bool] = None,
                    spawn_timeout_s: float = 120.0,
                    trace: bool = True,
                    device: Optional[str] = None) -> dict:
    """The DISAGGREGATED serve soak (acceptance for the disagg
    tentpole): ``prefill`` + ``decode`` worker processes behind a
    :class:`~horovod_tpu_torch.serve.disagg.DisaggRouter`, a seeded
    disagg-profile plan (one PREFILL worker SIGKILLed mid-traffic, a
    ``serve.migrate`` ``conn_reset`` severing a migration after its
    frame landed, a ``corrupt`` flipping a payload bit the block crc
    must catch), closed-loop traffic, and a v2 weight publish
    mid-incident. ``trace=True`` (the default) arms the distributed-
    tracing plane for the run — the verdict gains ``traces_complete``
    and the out dir ``traces.jsonl`` + ``trace.json`` (the merged Chrome
    trace). ``device``: where the workers and the publisher build the
    model (None: the card). Returns the :func:`evaluate_disagg`
    verdict; never raises on a failed invariant."""
    import tempfile

    from ..chaos import inject
    from ..native.store import StoreServer
    from ..redist.stream import WeightPublisher
    from .disagg import DisaggRouter
    from .worker import tiny_gpt_builder

    from ..chaos.plan import ChaosPlan, random_plan
    if plan is None or plan == "random":
        resolved = random_plan(seed, prefill + decode, steps,
                               profile="disagg", prefill=prefill)
    elif isinstance(plan, ChaosPlan):
        resolved = plan
    else:
        resolved = ChaosPlan.parse(str(plan))

    work_dir = out_dir or tempfile.mkdtemp(prefix="hvd_disagg_soak.")
    os.makedirs(work_dir, exist_ok=True)
    events_dir = os.path.join(work_dir, "worker_events")
    channel = f"disaggsoak{seed}"

    events: List[dict] = []
    records: List[dict] = []
    ev_lock = threading.Lock()

    def log_event(kind: str, ev: dict) -> None:
        with ev_lock:
            events.append(dict(ev, kind=kind))

    srv = StoreServer()
    built = tiny_gpt_builder(seed=seed, paged=True, draft=spec_k > 0,
                             device=device)
    pub = WeightPublisher(channel, kv_addr="127.0.0.1",
                          kv_port=srv.port, resume_timeout=0.05)
    pub.publish(built["params"])              # version 1, pre-incident

    stop = threading.Event()
    torn_down = []
    router = None

    def _teardown() -> None:
        # idempotent and reached on EVERY exit path — INCLUDING a
        # router-construction or injector-install failure, so the
        # store server/publisher/global injector never leak into the
        # caller's process, and the two pools' real OS processes
        # never outlive the soak
        if torn_down:
            return
        torn_down.append(True)
        stop.set()
        if router is not None:
            try:
                router.close()
            except Exception:  # noqa: BLE001
                pass
        inject.uninstall()
        try:
            pub.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            srv.close()
        except Exception:  # noqa: BLE001
            pass

    try:
        worker = {
            "builder": "horovod_tpu_torch.serve.worker:tiny_gpt_builder",
            "builder_kwargs": {"seed": seed, "paged": True,
                               "draft": spec_k > 0},
            "buckets": [8], "max_queue": max(32, 4 * clients),
            "deadline_ms": deadline_ms,
            "kv_crc": True if kv_crc is None else kv_crc,
            "spec_k": spec_k,
            "prefix_cache": True if prefix_cache is None
            else prefix_cache}
        if device is not None:
            worker["device"] = str(device)
        # arm tracing for the router's assembler_from_env read, then
        # restore — the soak must not leak the knob into the caller
        # knob: exempt (harness save/restore around router construction)
        prev_trace = os.environ.get("HOROVOD_TRACE")
        if trace:
            # knob: exempt (harness arms the knob for the construction)
            os.environ["HOROVOD_TRACE"] = "1"
        try:
            router = DisaggRouter(
                prefill, decode, kv_addr="127.0.0.1",
                kv_port=srv.port,
                prefill_worker=dict(worker, spec_k=0),
                decode_worker=worker,
                channel=channel, ns=f"dsoak{seed}",
                interval_s=interval_s,
                suspect_s=suspect_s, chaos_plan=resolved,
                events_dir=events_dir,
                log_dir=os.path.join(work_dir, "logs"),
                spawn_timeout_s=spawn_timeout_s)
        finally:
            if trace:
                if prev_trace is None:
                    os.environ.pop("HOROVOD_TRACE", None)
                else:
                    # knob: exempt (harness restores the caller's env)
                    os.environ["HOROVOD_TRACE"] = prev_trace
        router.add_listener(lambda ev: log_event("fleet", ev))

        inj = inject.install(resolved, rank=0)
        inj.add_listener(lambda ev: log_event(
            "chaos", {"fault": ev["kind"],
                      **{k: x for k, x in ev.items() if k != "kind"}}))
        if router.tracer is not None:
            # feed chaos injections into the flight recorder's event
            # ring (fleet events already arrive via the pool routers)
            inj.add_listener(lambda ev: router.tracer.note_event(
                {"kind": "chaos", **ev}))

        crash_scheduled = any(f.kind == "crash"
                              for f in resolved.faults)
        eject_seen = threading.Event()
        if not crash_scheduled:
            eject_seen.set()

        def watch_eject(ev):
            if ev.get("event") == "eject":
                eject_seen.set()
        router.add_listener(watch_eject)

        return _disagg_soak_body(
            router, resolved, events, records, ev_lock, events_dir,
            work_dir, pub, built, eject_seen, stop, _teardown,
            prefill=prefill, decode=decode, clients=clients,
            suspect_s=suspect_s, slo_p99_ms=slo_p99_ms,
            slo_error_rate=slo_error_rate,
            recovery_window_s=recovery_window_s,
            min_duration_s=min_duration_s,
            max_duration_s=max_duration_s,
            max_new_tokens=max_new_tokens, deadline_ms=deadline_ms,
            spec_k=spec_k)
    finally:
        _teardown()


def _disagg_soak_body(router, resolved, events, records, ev_lock,
                      events_dir, work_dir, pub, built, eject_seen,
                      stop, teardown, *, prefill, decode, clients,
                      suspect_s, slo_p99_ms, slo_error_rate,
                      recovery_window_s, min_duration_s,
                      max_duration_s, max_new_tokens, deadline_ms,
                      spec_k) -> dict:
    """The guarded body of :func:`run_disagg_soak` — every exit path
    runs the caller's teardown."""
    import glob

    from .queue import Rejected

    router.start()
    replicas = prefill + decode

    def publish_fresh():
        eject_seen.wait(timeout=max_duration_s / 2.0)
        time.sleep(0.5)
        try:
            pub.publish(built["params"])      # version 2, same values
        except Exception as e:  # noqa: BLE001
            logger.error("disagg soak: mid-incident publish failed: "
                         "%s", e)

    threading.Thread(target=publish_fresh, daemon=True).start()

    rec_lock = threading.Lock()

    def client(cid: int) -> None:
        import numpy as np
        rng = np.random.RandomState(30_000 + cid)
        while not stop.is_set():
            prompt = list(rng.randint(1, 64, int(rng.randint(2, 8))))
            # WALL-clock stamps: the verdict intersects these with the
            # event ledger's time.time() recovery windows
            t0 = time.time()
            rec = {"fid": None, "t0": t0, "t1": None,
                   "status": "pending", "latency_ms": None,
                   "retry_after_ms": None, "resolutions": 0,
                   "replica": None, "client": cid}
            try:
                h = router.submit(prompt,
                                  max_new_tokens=max_new_tokens)
            except Rejected as e:
                rec.update(status="shed",
                           retry_after_ms=e.retry_after_ms,
                           t1=time.time())
                with rec_lock:
                    records.append(rec)
                time.sleep(min((e.retry_after_ms or 100.0), 500.0)
                           / 1000.0)
                continue
            h.wait(timeout=deadline_ms / 1000.0 + 60.0)
            rec.update(fid=h.fid, t1=time.time(),
                       status=h.status, latency_ms=h.latency_ms,
                       retry_after_ms=h.retry_after_ms,
                       resolutions=h.resolutions, replica=h.replica)
            with rec_lock:
                records.append(rec)
            if h.status == "rejected" and h.retry_after_ms:
                time.sleep(min(h.retry_after_ms, 500.0) / 1000.0)
            time.sleep(0.005)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t_start = time.monotonic()
    for t in threads:
        t.start()

    def worker_chaos_events() -> List[dict]:
        out = []
        for path in sorted(glob.glob(
                os.path.join(events_dir, "*.events.jsonl"))):
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        ev = json.loads(line)
                        out.append({"kind": "chaos",
                                    "fault": ev.get("kind"),
                                    **{k: x for k, x in ev.items()
                                       if k != "kind"}})
            except (OSError, ValueError):
                # resilience: exempt (local event-ledger file read —
                # a half-written line is re-read next poll)
                continue
        return out

    want = {(f.site, f.kind, f.peer) for f in resolved.faults
            if f.kind != "flaky"}

    def faults_all_fired(worker_evs: List[dict]) -> bool:
        with ev_lock:
            got = {(e.get("site"), e.get("fault"), e.get("peer"))
                   for e in events if e.get("kind") == "chaos"}
        got |= {(e.get("site"), e.get("fault"), e.get("peer"))
                for e in worker_evs}
        return want <= got

    def recovered() -> bool:
        s = router.stats()
        newest = pub._version
        return (s["replicas_up"] == replicas and newest >= 2
                and all(r["weights_version"] == newest
                        for r in s["replicas"].values()))

    dwell_s = 2 * suspect_s + 1.0
    last_unhealed = time.monotonic()
    while time.monotonic() - t_start < max_duration_s:
        worker_evs = worker_chaos_events()
        with ev_lock:
            seen = events + worker_evs
        if not (faults_all_fired(worker_evs) and recovered()
                and _windows_closed(seen, recovery_window_s, dwell_s)):
            last_unhealed = time.monotonic()
        elif time.monotonic() - last_unhealed >= dwell_s \
                and time.monotonic() - t_start >= min_duration_s:
            break
        time.sleep(0.25)
    stop.set()
    for t in threads:
        t.join(timeout=deadline_ms / 1000.0 + 65.0)

    # final evidence pulls, per replica with the cached-sweep fallback
    # (same rule as the fleet soak: one missed last poll must not
    # evaporate evidence a fault DID recover)
    migrations_in = migrate_corrupt = migrate_absorbed = 0
    for pool in (router.prefill, router.decode):
        for rep in pool.replicas.values():
            h = pool._fetch_healthz(rep, timeout=1.0) or \
                rep.healthz_cache or {}
            migrations_in += int(h.get("migrations_in") or 0)
            migrate_corrupt += int(
                h.get("migrate_corrupt_detected") or 0)
            migrate_absorbed += int(h.get("migrate_absorbed") or 0)
    fleet_stats = router.stats()
    newest_version = pub._version
    worker_evs = worker_chaos_events()
    with ev_lock:
        all_events = sorted(events + worker_evs,
                            key=lambda e: e.get("t", 0.0))
    traces = None
    if router.tracer is not None:
        # pull the retained set + merged artifacts BEFORE teardown
        # tears the pools down (the assembler is in-memory state)
        traces = router.tracer.retained()
        try:
            router.tracer.write_jsonl(
                os.path.join(work_dir, "traces.jsonl"))
            router.tracer.write_chrome(
                os.path.join(work_dir, "trace.json"))
        except OSError as e:
            # resilience: exempt (local filesystem write of a soak
            # artifact — not a wire fault; the verdict still runs)
            logger.warning(
                "disagg soak: trace artifact write failed: %s", e)
    teardown()

    verdict = evaluate_disagg(
        records, all_events, resolved, fleet_stats,
        replicas=replicas, suspect_s=suspect_s,
        slo_p99_ms=slo_p99_ms, slo_error_rate=slo_error_rate,
        recovery_window_s=recovery_window_s,
        newest_version=newest_version,
        migrations_in=migrations_in,
        migrate_absorbed=migrate_absorbed,
        migrate_corrupt_detected=migrate_corrupt,
        reprefills=fleet_stats.get("reprefills", 0),
        traces=traces)
    verdict.update({
        "seed": resolved.seed, "prefill": prefill, "decode": decode,
        "clients": clients, "processes": True, "disagg": True,
        "traced": traces is not None,
        "spec_k": int(spec_k), "suspect_s": suspect_s,
        "wall_s": round(time.monotonic() - t_start, 2),
        "plan": json.loads(resolved.to_json()),
        "fleet": fleet_stats,
        "out_dir": work_dir,
    })
    with open(os.path.join(work_dir, "events.jsonl"), "w") as f:
        for e in all_events:
            f.write(json.dumps(e, default=str) + "\n")
    with open(os.path.join(work_dir, "requests.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    with open(os.path.join(work_dir, "verdict.json"), "w") as f:
        json.dump(verdict, f, indent=2, sort_keys=True)
    return verdict


def run_fleet_soak(out_dir: Optional[str] = None, *,
                   replicas: int = 2,
                   clients: int = 4,
                   seed: int = 0, plan=None,
                   steps: int = DEFAULT_STEPS,
                   suspect_s: float = FLEET_SUSPECT_S,
                   interval_s: float = DEFAULT_INTERVAL_S,
                   slo_p99_ms: float = DEFAULT_SLO_P99_MS,
                   slo_error_rate: float = DEFAULT_SLO_ERROR_RATE,
                   recovery_window_s: float = 8.0,
                   min_duration_s: float = 8.0,
                   max_duration_s: float = 150.0,
                   max_new_tokens: int = 8,
                   deadline_ms: float = 20000.0,
                   spec_k: int = 0,
                   paged: bool = True,
                   kv_crc: Optional[bool] = None,
                   prefix_cache: Optional[bool] = None,
                   spawn_timeout_s: float = 120.0,
                   device: Optional[str] = None) -> dict:
    """The MULTI-PROCESS serve soak (acceptance for the process-fleet
    tentpole): N replica WORKER PROCESSES behind a
    :class:`~horovod_tpu_torch.serve.proc_fleet.ProcessFleetRouter`, a
    seeded serve-profile plan with ``processes=True`` (one worker
    SIGKILLed mid-traffic, ``conn_reset``/``flaky`` blips on the
    dispatch wire, an admission drop), closed-loop traffic, and a v2
    weight publish mid-incident. ``device``: where the workers and the
    publisher build the model (None: the card). Returns the :func:`evaluate_fleet`
    verdict; never raises on a failed invariant."""
    import tempfile

    from ..chaos import inject
    from ..native.store import StoreServer
    from ..redist.stream import WeightPublisher
    from .proc_fleet import ProcessFleetRouter
    from .worker import tiny_gpt_builder

    from ..chaos.plan import ChaosPlan, random_plan
    if plan is None or plan == "random":
        resolved = random_plan(seed, replicas, steps, profile="serve",
                               processes=True)
    elif isinstance(plan, ChaosPlan):
        resolved = plan
    else:
        resolved = ChaosPlan.parse(str(plan))

    work_dir = out_dir or tempfile.mkdtemp(prefix="hvd_fleet_soak.")
    os.makedirs(work_dir, exist_ok=True)
    events_dir = os.path.join(work_dir, "worker_events")
    channel = f"fleetsoak{seed}"

    events: List[dict] = []
    records: List[dict] = []
    ev_lock = threading.Lock()

    def log_event(kind: str, ev: dict) -> None:
        with ev_lock:
            events.append(dict(ev, kind=kind))

    srv = StoreServer()
    # the publisher derives the SAME params every worker builds
    # (deterministic per seed) — v1 lands before any worker spawns, so
    # every startup passes the weight gate against a live channel
    built = tiny_gpt_builder(seed=seed, paged=paged,
                             draft=spec_k > 0, device=device)
    pub = WeightPublisher(channel, kv_addr="127.0.0.1",
                          kv_port=srv.port, resume_timeout=0.05)
    pub.publish(built["params"])              # version 1, pre-incident

    worker = {
        "builder": "horovod_tpu_torch.serve.worker:tiny_gpt_builder",
        "builder_kwargs": {"seed": seed, "paged": paged,
                           "draft": spec_k > 0},
        "buckets": [8], "max_queue": max(32, 4 * clients),
        "deadline_ms": deadline_ms,
        "kv_crc": True if kv_crc is None else kv_crc,
        "spec_k": spec_k,
        "prefix_cache": paged if prefix_cache is None else prefix_cache}
    if device is not None:
        worker["device"] = str(device)
    router = ProcessFleetRouter(
        replicas, kv_addr="127.0.0.1", kv_port=srv.port, worker=worker,
        channel=channel, ns=f"soak{seed}", interval_s=interval_s,
        suspect_s=suspect_s, chaos_plan=resolved,
        events_dir=events_dir,
        log_dir=os.path.join(work_dir, "logs"),
        spawn_timeout_s=spawn_timeout_s)
    router.add_listener(lambda ev: log_event("fleet", ev))

    # arm the ROUTER process (serve.dispatch fires here; serve.proc /
    # serve.admit fire inside the workers, which install the same plan
    # from their spawn config and ledger into events_dir)
    inj = inject.install(resolved, rank=0)
    inj.add_listener(lambda ev: log_event(
        "chaos", {"fault": ev["kind"],
                  **{k: x for k, x in ev.items() if k != "kind"}}))

    crash_scheduled = any(f.kind == "crash" for f in resolved.faults)
    eject_seen = threading.Event()
    if not crash_scheduled:
        eject_seen.set()

    def watch_eject(ev):
        if ev.get("event") == "eject":
            eject_seen.set()
    router.add_listener(watch_eject)

    stop = threading.Event()
    torn_down = []

    def _teardown() -> None:
        # idempotent, best-effort, and REACHED ON EVERY EXIT PATH: the
        # replicas are real OS processes in their own sessions — an
        # exception anywhere in the soak body must not orphan them
        # spinning forever
        if torn_down:
            return
        torn_down.append(True)
        stop.set()
        try:
            router.close()
        except Exception:  # noqa: BLE001
            pass
        inject.uninstall()
        try:
            pub.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            srv.close()
        except Exception:  # noqa: BLE001
            pass

    try:
        return _fleet_soak_body(
            router, resolved, events, records, ev_lock, events_dir,
            work_dir, pub, built, eject_seen, stop, _teardown,
            replicas=replicas, clients=clients,
            suspect_s=suspect_s, slo_p99_ms=slo_p99_ms,
            slo_error_rate=slo_error_rate,
            recovery_window_s=recovery_window_s,
            min_duration_s=min_duration_s,
            max_duration_s=max_duration_s,
            max_new_tokens=max_new_tokens, deadline_ms=deadline_ms,
            spec_k=spec_k, paged=paged)
    finally:
        _teardown()


def _fleet_soak_body(router, resolved, events, records, ev_lock,
                     events_dir, work_dir, pub, built, eject_seen,
                     stop, teardown, *, replicas, clients, suspect_s,
                     slo_p99_ms, slo_error_rate, recovery_window_s,
                     min_duration_s, max_duration_s, max_new_tokens,
                     deadline_ms, spec_k, paged) -> dict:
    """The guarded body of :func:`run_fleet_soak` — every exit path
    runs the caller's teardown (worker processes must never outlive
    the soak)."""
    import glob

    from .queue import Rejected

    router.start()

    def publish_fresh():
        # the online-learning leg: v2 lands while the fleet is mid-
        # incident; the RESPAWNED victim must come back gated on it
        eject_seen.wait(timeout=max_duration_s / 2.0)
        time.sleep(0.5)
        try:
            pub.publish(built["params"])      # version 2, same values
        except Exception as e:  # noqa: BLE001
            logger.error("fleet soak: mid-incident publish failed: %s",
                         e)

    threading.Thread(target=publish_fresh, daemon=True).start()

    rec_lock = threading.Lock()

    def client(cid: int) -> None:
        import numpy as np
        rng = np.random.RandomState(20_000 + cid)
        while not stop.is_set():
            prompt = list(rng.randint(1, 64, int(rng.randint(2, 8))))
            # WALL-clock stamps: the verdict intersects these with the
            # event ledger's time.time() recovery windows — a monotonic
            # stamp here would make every request look "outside" every
            # window and quietly disable the SLO exclusion
            t0 = time.time()
            rec = {"fid": None, "t0": t0, "t1": None,
                   "status": "pending", "latency_ms": None,
                   "retry_after_ms": None, "resolutions": 0,
                   "replica": None, "client": cid}
            try:
                h = router.submit(prompt,
                                  max_new_tokens=max_new_tokens)
            except Rejected as e:
                rec.update(status="shed",
                           retry_after_ms=e.retry_after_ms,
                           t1=time.time())
                with rec_lock:
                    records.append(rec)
                time.sleep(min((e.retry_after_ms or 100.0), 500.0)
                           / 1000.0)
                continue
            h.wait(timeout=deadline_ms / 1000.0 + 60.0)
            rec.update(fid=h.fid, t1=time.time(),
                       status=h.status, latency_ms=h.latency_ms,
                       retry_after_ms=h.retry_after_ms,
                       resolutions=h.resolutions, replica=h.replica)
            with rec_lock:
                records.append(rec)
            if h.status == "rejected" and h.retry_after_ms:
                time.sleep(min(h.retry_after_ms, 500.0) / 1000.0)
            time.sleep(0.005)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t_start = time.monotonic()
    for t in threads:
        t.start()

    def worker_chaos_events() -> List[dict]:
        """Read the workers' fsync'd injector ledgers (the victim's
        SIGKILL is recorded there a syscall before it dies)."""
        out = []
        for path in sorted(glob.glob(
                os.path.join(events_dir, "*.events.jsonl"))):
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        ev = json.loads(line)
                        out.append({"kind": "chaos",
                                    "fault": ev.get("kind"),
                                    **{k: x for k, x in ev.items()
                                       if k != "kind"}})
            except (OSError, ValueError):
                # resilience: exempt (local event-ledger file read, not
                # a wire path — a half-written line is re-read next poll)
                continue
        return out

    # distinct scheduled faults only, flaky excluded: its seeded draws
    # may legitimately never hit inside the window, and waiting on a
    # fault that cannot be forced would stall the soak to its cap
    want = {(f.site, f.kind, f.peer) for f in resolved.faults
            if f.kind != "flaky"}

    def faults_all_fired(worker_evs: List[dict]) -> bool:
        with ev_lock:
            got = {(e.get("site"), e.get("fault"), e.get("peer"))
                   for e in events if e.get("kind") == "chaos"}
        got |= {(e.get("site"), e.get("fault"), e.get("peer"))
                for e in worker_evs}
        return want <= got

    def recovered() -> bool:
        s = router.stats()
        newest = pub._version
        return (s["replicas_up"] == replicas and newest >= 2
                and all(r["weights_version"] == newest
                        for r in s["replicas"].values()))

    dwell_s = 2 * suspect_s + 1.0
    last_unhealed = time.monotonic()
    while time.monotonic() - t_start < max_duration_s:
        worker_evs = worker_chaos_events()
        with ev_lock:
            seen = events + worker_evs
        if not (faults_all_fired(worker_evs) and recovered()
                and _windows_closed(seen, recovery_window_s, dwell_s)):
            last_unhealed = time.monotonic()
        elif time.monotonic() - last_unhealed >= dwell_s \
                and time.monotonic() - t_start >= min_duration_s:
            break
        time.sleep(0.25)
    stop.set()
    for t in threads:
        t.join(timeout=deadline_ms / 1000.0 + 65.0)

    # final, fresh evidence pulls before teardown; per replica, a
    # missed probe (loaded box, transient connect failure) falls back
    # to the sweep's cached count — evidence the dedupe DID happen
    # must not evaporate because one last poll did
    dedupe_hits = 0
    for rep in router.replicas.values():
        h = router._fetch_healthz(rep, timeout=1.0)
        probed = int(h.get("dedupe_hits") or 0) if h is not None else 0
        dedupe_hits += max(probed, int(rep.dedupe_hits or 0))
    fleet_stats = router.stats()
    from ..obs import metrics as obs_metrics
    from ..native.resilience import RETRIES_HELP
    dispatch_absorbed = int(obs_metrics.get_registry().counter(
        "hvd_net_retries_total", RETRIES_HELP,
        {"site": "serve.dispatch", "outcome": "absorbed"}).value)
    newest_version = pub._version
    worker_evs = worker_chaos_events()
    with ev_lock:
        all_events = sorted(events + worker_evs,
                            key=lambda e: e.get("t", 0.0))
    teardown()

    verdict = evaluate_fleet(
        records, all_events, resolved, fleet_stats,
        replicas=replicas, suspect_s=suspect_s,
        slo_p99_ms=slo_p99_ms, slo_error_rate=slo_error_rate,
        recovery_window_s=recovery_window_s,
        newest_version=newest_version,
        dispatch_absorbed=dispatch_absorbed,
        dedupe_hits=dedupe_hits)
    verdict.update({
        "seed": resolved.seed, "replicas": replicas,
        "clients": clients, "processes": True,
        "paged": bool(paged), "spec_k": int(spec_k),
        "suspect_s": suspect_s,
        "wall_s": round(time.monotonic() - t_start, 2),
        "plan": json.loads(resolved.to_json()),
        "fleet": fleet_stats,
        "out_dir": work_dir,
    })
    with open(os.path.join(work_dir, "events.jsonl"), "w") as f:
        for e in all_events:
            f.write(json.dumps(e, default=str) + "\n")
    with open(os.path.join(work_dir, "requests.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    with open(os.path.join(work_dir, "verdict.json"), "w") as f:
        json.dump(verdict, f, indent=2, sort_keys=True)
    return verdict


def run_serve_soak(out_dir: Optional[str] = None, *,
                   replicas: int = DEFAULT_REPLICAS,
                   clients: int = DEFAULT_CLIENTS,
                   seed: int = 0, plan=None,
                   steps: int = DEFAULT_STEPS,
                   suspect_s: float = DEFAULT_SUSPECT_S,
                   interval_s: float = DEFAULT_INTERVAL_S,
                   slo_p99_ms: float = DEFAULT_SLO_P99_MS,
                   slo_error_rate: float = DEFAULT_SLO_ERROR_RATE,
                   recovery_window_s: float = DEFAULT_RECOVERY_WINDOW_S,
                   min_duration_s: float = 8.0,
                   max_duration_s: float = 45.0,
                   max_new_tokens: int = 8,
                   deadline_ms: float = 20000.0,
                   kv_crc: Optional[bool] = None,
                   paged: bool = True,
                   prefix_cache: Optional[bool] = None,
                   spec_k: int = 3,
                   sigterm_drain: bool = False,
                   device: Optional[str] = None) -> dict:
    """Run the serving soak in-process and return the verdict dict.
    Never raises on a failed invariant — the verdict carries the
    evidence; it raises only on harness misuse. ``device``: where the
    replicas run (None: the card)."""
    import numpy as np

    from .._device import resolve_device
    from ..chaos import inject
    from ..native.store import StoreServer
    from ..redist.stream import WeightPublisher, WeightSubscriber
    from .executor import ShardedExecutor
    from .fleet import FleetRouter, Replica
    from .queue import Rejected
    from .worker import tiny_gpt_builder

    if kv_crc is None:
        kv_crc = True   # the corrupt invariant NEEDS the crc ledger
    if prefix_cache is None:
        prefix_cache = paged   # paged-only feature
    resolved = _resolve_plan(plan, seed, replicas, steps)

    # -- tiny decode-mode model: identical params on every replica.
    # The soak's DEFAULT configuration is the full serving tier —
    # paged KV blocks + radix prefix cache + speculative decoding —
    # because this soak is the regression harness for those paths: a
    # serve.kv corrupt must be caught by the per-BLOCK crc, failover
    # must survive block-table teardown, and the version fence must
    # flush prefix runs on the mid-incident weight publish. The
    # drafter shares the target's params (a perfectly distilled
    # proposer): the accept path runs hot while the verify step keeps
    # the bit-identical guarantee for whatever the drafter proposes.
    # Each replica owns its modules (an executor serves its model's
    # own parameters); every build draws the same bits from the seed.
    dev = resolve_device(device)

    def build():
        return tiny_gpt_builder(seed=seed, paged=paged,
                                draft=bool(spec_k), device=dev)

    built = [build() for _ in range(replicas)]
    params = built[0]["params"]

    events: List[dict] = []
    records: List[dict] = []
    ev_lock = threading.Lock()

    def log_event(kind: str, ev: dict) -> None:
        with ev_lock:
            events.append(dict(ev, kind=kind))

    srv = StoreServer()
    pub = WeightPublisher("soak", kv_addr="127.0.0.1",
                          kv_port=srv.port, resume_timeout=0.05)
    pub.publish(params)                       # version 1, pre-incident
    reps = [
        Replica(i,
                ShardedExecutor(b["model"], max_batch=4, max_len=48,
                                device=dev, replica_id=i),
                buckets=(8,), max_queue=max(32, 4 * clients),
                deadline_ms=deadline_ms, kv_crc=kv_crc,
                draft_executor=(None if b["draft_model"] is None else
                                ShardedExecutor(
                                    b["draft_model"], max_batch=4,
                                    max_len=48, device=dev,
                                    replica_id=i, role="draft")),
                spec_k=spec_k, prefix_cache=prefix_cache,
                subscriber=WeightSubscriber(
                    "soak", kv_addr="127.0.0.1", kv_port=srv.port,
                    template=b["model"]))
        for i, b in enumerate(built)]
    router = FleetRouter(reps, interval_s=interval_s,
                         suspect_s=suspect_s)
    router.add_listener(lambda ev: log_event("fleet", ev))

    inj = inject.install(resolved, rank=0)
    # the injector's "kind" names the FAULT; the event ledger's "kind"
    # names the record type (chaos/fleet) — same renaming as chaos/soak
    inj.add_listener(lambda ev: log_event(
        "chaos", {"fault": ev["kind"],
                  **{k: x for k, x in ev.items() if k != "kind"}}))

    router.start()
    if sigterm_drain:        # CLI mode (main thread): orderly shutdown
        router.install_sigterm()

    stop = threading.Event()
    crash_seen = threading.Event()
    for f in resolved.faults:
        if f.kind == "crash":
            break
    else:
        crash_seen.set()   # crash-free custom plan: publish mid-run

    def watch_crash(ev):
        if ev.get("kind") == "crash":
            crash_seen.set()
    inj.add_listener(watch_crash)

    def publish_fresh():
        # the online-learning leg: a NEW weight version lands while the
        # fleet is mid-incident; the restarted victim must come back on
        # it (and every healthy replica must adopt it) before the
        # verdict calls the fleet recovered
        crash_seen.wait(timeout=max_duration_s / 2.0)
        time.sleep(0.5)
        try:
            pub.publish(params)               # version 2, same values
        except Exception as e:  # noqa: BLE001
            logger.error("soak: mid-incident publish failed: %s", e)

    pub_thread = threading.Thread(target=publish_fresh, daemon=True)
    pub_thread.start()

    rec_lock = threading.Lock()

    def client(cid: int) -> None:
        rng = np.random.RandomState(10_000 + cid)
        while not stop.is_set():
            prompt = list(rng.randint(1, 64, int(rng.randint(2, 8))))
            # WALL-clock stamps: the recovery windows in the verdict
            # are built from the event ledger's time.time() — monotonic
            # stamps here would never intersect them, silently
            # disabling the SLO window exclusion
            t0 = time.time()
            rec = {"fid": None, "t0": t0, "t1": None,
                   "status": "pending", "latency_ms": None,
                   "retry_after_ms": None, "resolutions": 0,
                   "replica": None, "client": cid}
            try:
                h = router.submit(prompt,
                                  max_new_tokens=max_new_tokens)
            except Rejected as e:
                rec.update(status="shed",
                           retry_after_ms=e.retry_after_ms,
                           t1=time.time())
                with rec_lock:
                    records.append(rec)
                # honor the hint (capped so the soak keeps offering)
                time.sleep(min((e.retry_after_ms or 100.0), 500.0)
                           / 1000.0)
                continue
            h.wait(timeout=deadline_ms / 1000.0 + 30.0)
            rec.update(fid=h.fid, t1=time.time(),
                       status=h.status, latency_ms=h.latency_ms,
                       retry_after_ms=h.retry_after_ms,
                       resolutions=h.resolutions, replica=h.replica)
            with rec_lock:
                records.append(rec)
            time.sleep(0.005)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t_start = time.monotonic()
    for t in threads:
        t.start()

    def recovered() -> bool:
        s = router.stats()
        newest = pub._version
        return (s["replicas_up"] == replicas and newest >= 2
                and all(r["weights_version"] == newest
                        for r in s["replicas"].values()))

    # distinct scheduled faults only: the injector also emits synthetic
    # partition-window refusals, which must not count as "fired"
    want = {(f.site, f.kind, f.peer) for f in resolved.faults}

    def faults_all_fired() -> bool:
        with ev_lock:
            got = {(e.get("site"), e.get("fault"), e.get("peer"))
                   for e in events if e.get("kind") == "chaos"}
        return want <= got

    # run until the WHOLE incident has played out (every scheduled
    # fault fired) AND the fleet healed — and STAYED healed for a
    # dwell longer than the detector's reaction time: a just-fired
    # slow fault leaves the fleet looking healthy for up to suspect_s
    # before its ejection lands, and sampling that gap would declare
    # victory mid-incident. Traffic keeps flowing during recovery so
    # the adoption/readmission paths run under load, like production
    # would. (Bounded by max_duration_s either way.)
    dwell_s = 2 * suspect_s + 1.0
    last_unhealed = time.monotonic()
    while time.monotonic() - t_start < max_duration_s:
        with ev_lock:
            seen = list(events)
        if not (faults_all_fired() and recovered()
                and _windows_closed(seen, recovery_window_s, dwell_s)):
            last_unhealed = time.monotonic()
        elif time.monotonic() - last_unhealed >= dwell_s \
                and time.monotonic() - t_start >= min_duration_s:
            break
        time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join(timeout=deadline_ms / 1000.0 + 35.0)

    fleet_stats = router.stats()
    kv_injected = sum(r.batcher.kv_corruptions_injected
                      for r in reps if r.batcher is not None)
    kv_detected = sum(r.batcher.kv_corruptions_detected
                      for r in reps if r.batcher is not None)
    prefix_hits = sum(r.batcher.prefix.hits for r in reps
                      if r.batcher is not None
                      and r.batcher.prefix is not None)
    prefix_saved = sum(r.batcher.prefix.tokens_saved for r in reps
                       if r.batcher is not None
                       and r.batcher.prefix is not None)
    spec_steps = sum(r.batcher.gen_steps for r in reps
                     if r.batcher is not None)
    spec_tokens = sum(r.batcher.gen_tokens for r in reps
                      if r.batcher is not None)
    newest_version = pub._version
    router.close()
    inject.uninstall()
    pub.close()
    for r in reps:
        if r.subscriber is not None:
            r.subscriber.close()
    srv.close()

    verdict = evaluate_serve(
        records, sorted(events, key=lambda e: e.get("t", 0.0)),
        resolved, fleet_stats, replicas=replicas, suspect_s=suspect_s,
        slo_p99_ms=slo_p99_ms, slo_error_rate=slo_error_rate,
        recovery_window_s=recovery_window_s,
        newest_version=newest_version, kv_injected=kv_injected,
        kv_detected=kv_detected)
    verdict.update({
        "seed": resolved.seed, "replicas": replicas,
        "clients": clients, "kv_crc": bool(kv_crc),
        "paged": bool(paged), "prefix_cache": bool(prefix_cache),
        "spec_k": int(spec_k),
        "prefix_hits": prefix_hits,
        "prefix_tokens_saved": prefix_saved,
        # target steps per generated token since the LAST rebuild of
        # each surviving batcher — informational; the bench gate is
        # where the < 0.7 bound is asserted
        "target_steps_per_token": (
            round(spec_steps / spec_tokens, 3) if spec_tokens else None),
        "suspect_s": suspect_s,
        "wall_s": round(time.monotonic() - t_start, 2),
        "plan": json.loads(resolved.to_json()),
        "fleet": fleet_stats,
    })
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "events.jsonl"), "w") as f:
            for e in events:
                f.write(json.dumps(e, default=str) + "\n")
        with open(os.path.join(out_dir, "requests.jsonl"), "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        with open(os.path.join(out_dir, "verdict.json"), "w") as f:
            json.dump(verdict, f, indent=2, sort_keys=True)
    return verdict


def evaluate_autoscale(records: List[dict], events: List[dict], plan,
                       fleet_stats: dict, *, slo_p99_ms: float,
                       slo_error_rate: float,
                       recovery_window_s: float,
                       newest_version: Optional[int],
                       min_per_pool: int) -> dict:
    """The AUTOSCALE verdict: the serve invariants (zero silent drops,
    answered-once, sheds carry retry hints, SLO outside recovery
    windows) plus the scaling-loop invariants:

    * **scaled_up / scaled_down** — EVERY pool (prefill and decode)
      grew at least once under the burst and shrank at least once in
      the cool phase: a soak where one pool never moved proves nothing
      about that pool's loop.
    * **scale_actions_ok** — no applied action failed: a crash-faulted
      scale-up must end admitted (the spawn retry), a drop-faulted
      scale-down must end removed (the hard-kill path with its
      requeue discipline).
    * **newcomers_on_newest** — every admitted newcomer entered on the
      newest published weight version (the respawn gate, generalized).
    * **faults_all_fired** — when a chaos plan was installed, every
      scheduled ``autoscale.scale`` fault actually landed.
    * **capacity_restored** — the fleet ends scaled back down: every
      pool at its floor with every survivor on the newest weights.

    Recovery windows open around every chaos fault AND every applied
    scale event (a spawn or drain is a planned disruption: the SLO is
    asserted on traffic that does not overlap one).
    """
    v: Dict[str, Any] = {
        "submitted": len(records), "statuses": {},
        "no_silent_drops": None, "answered_once": None,
        "shed_carry_retry_after": None,
        "scaled_up": None, "scaled_down": None,
        "scale_actions_ok": None, "newcomers_on_newest": None,
        "faults_all_fired": None, "slo_held": None,
        "p99_outside_ms": None, "error_rate_outside": None,
        "clean_ok_samples": None, "capacity_restored": None,
        "duplicates_suppressed":
            fleet_stats.get("duplicates_suppressed", 0),
    }
    statuses: Dict[str, int] = {}
    for r in records:
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    v["statuses"] = statuses
    v["no_silent_drops"] = (
        len(records) > 0
        and all(r["status"] != "pending" for r in records)
        and fleet_stats.get("inflight", 0) == 0)
    v["answered_once"] = all(r.get("resolutions", 1) <= 1
                             for r in records)
    shed = [r for r in records if r["status"] in ("shed", "rejected")]
    v["shed_carry_retry_after"] = all(
        (r.get("retry_after_ms") or 0) > 0 for r in shed)

    # -- the scaling loop actually closed, in BOTH directions, per pool
    scale = [e for e in events if e.get("kind") == "scale"]
    counts: Dict[str, Dict[str, int]] = {}
    for e in scale:
        if e.get("ok"):
            c = counts.setdefault(e.get("pool"), {"up": 0, "down": 0})
            c[e.get("direction")] = c.get(e.get("direction"), 0) + 1
    v["scale_events"] = {p: dict(c) for p, c in sorted(counts.items())}
    pools = ("prefill", "decode")
    v["scaled_up"] = all(counts.get(p, {}).get("up", 0) > 0
                         for p in pools)
    v["scaled_down"] = all(counts.get(p, {}).get("down", 0) > 0
                           for p in pools)
    v["scale_actions_ok"] = (len(scale) > 0
                             and all(e.get("ok") for e in scale))

    ups = [e for e in scale if e.get("direction") == "up"
           and e.get("ok")]
    v["newcomers_on_newest"] = (
        len(ups) > 0 and newest_version is not None
        and all(e.get("weights_version") == newest_version
                for e in ups))

    if plan is not None and plan.faults:
        want = {(f.site, f.kind) for f in plan.faults}
        got = {(e.get("site"), e.get("fault")) for e in events
               if e.get("kind") == "chaos"}
        v["faults_all_fired"] = want <= got

    # -- SLO outside recovery windows: chaos faults AND scale events
    # are both planned disruptions
    windows = [(e["t"], e["t"] + recovery_window_s) for e in events
               if (e.get("kind") == "chaos"
                   and e.get("fault") in _DISRUPTIVE)
               or e.get("kind") == "scale"]

    def outside(r):
        return not any(r["t0"] < hi and r["t1"] > lo
                       for lo, hi in windows)

    clean = [r for r in records if outside(r)]
    oks = sorted(r["latency_ms"] for r in clean
                 if r["status"] == "ok"
                 and r.get("latency_ms") is not None)
    v["clean_ok_samples"] = len(oks)
    served = [r for r in clean
              if r["status"] not in ("shed", "rejected")]
    errs = [r for r in served if r["status"] in ("error", "expired")]
    if len(oks) >= 20:
        v["p99_outside_ms"] = round(
            oks[min(len(oks) - 1, int(0.99 * len(oks)))], 1)
        v["error_rate_outside"] = round(
            len(errs) / max(len(served), 1), 4)
        v["slo_held"] = (v["p99_outside_ms"] <= slo_p99_ms
                         and v["error_rate_outside"] <= slo_error_rate)
    else:
        v["slo_held"] = False   # too few clean samples to claim an SLO

    # -- ends scaled back to the floor, everyone on newest weights
    p_stats = fleet_stats.get("prefill", {})
    d_stats = fleet_stats.get("decode", {})
    versions = [r.get("weights_version")
                for r in fleet_stats.get("replicas", {}).values()]
    v["capacity_restored"] = (
        p_stats.get("replicas_up") == min_per_pool
        and d_stats.get("replicas_up") == min_per_pool
        and newest_version is not None
        and all(ver == newest_version for ver in versions))

    v["ok"] = all(v[k] is not False for k in (
        "no_silent_drops", "answered_once", "shed_carry_retry_after",
        "scaled_up", "scaled_down", "scale_actions_ok",
        "newcomers_on_newest", "faults_all_fired", "slo_held",
        "capacity_restored"))
    return v


def run_autoscale_soak(out_dir: Optional[str] = None, **kwargs) -> dict:
    """The AUTOSCALE soak needs ``autoscale/`` (the ``Autoscaler``, its
    policy and signal source), which the port does not have yet; its
    verdict, :func:`evaluate_autoscale`, is ported."""
    raise NotImplementedError(
        "run_autoscale_soak needs horovod_tpu_torch.autoscale, not ported "
        "yet: ROADMAP.md item 13 (fault planes)")


def evaluate_kvtier(records: List[dict], events: List[dict], plan,
                    fleet_stats: dict, tier: dict) -> dict:
    """The FLEET-KV-TIER verdict: the serve hygiene invariants (zero
    silent drops, answered-once, sheds carry retry hints) plus the
    tier's own contract —

    * the ladder actually moved: demotions AND promotions > 0 (a soak
      whose pool never pressured the prefix cache proves nothing);
    * **cross-replica hits**: the fleet index steered > 0 dispatches at
      the replica holding the request's longest cached run
      (``hvd_serve_kvtier_routed_total``);
    * **bit-identical tokens**: every repeat of the same (prompt,
      max_new_tokens) — cold, promoted, or re-prefilled after a drop —
      produced the same token sequence;
    * **corrupt caught before install**: every ``kvtier.promote``
      corrupt that fired was caught by the per-leaf crc gate
      (``corrupt_detected`` >= fired), and no request errored;
    * **drop degrades to re-prefill**: the scheduled drops fired, the
      drop counters moved, and still zero ``error`` statuses — a lost
      tier move is a cache miss, never a failure.
    """
    v: Dict[str, Any] = {
        "submitted": len(records), "statuses": {},
        "no_silent_drops": None, "answered_once": None,
        "shed_carry_retry_after": None,
        "ladder_exercised": None, "cross_replica_hit": None,
        "tokens_bit_identical": None, "corrupt_caught": None,
        "drops_degraded": None, "no_errors": None,
        "faults_fired": None, "tier": tier,
    }
    statuses: Dict[str, int] = {}
    for r in records:
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    v["statuses"] = statuses
    v["no_silent_drops"] = (
        len(records) > 0
        and all(r["status"] != "pending" for r in records)
        and fleet_stats.get("inflight", 0) == 0)
    v["answered_once"] = all(r.get("resolutions", 1) <= 1
                             for r in records)
    shed = [r for r in records if r["status"] in ("shed", "rejected")]
    v["shed_carry_retry_after"] = all(
        (r.get("retry_after_ms") or 0) > 0 for r in shed)
    v["no_errors"] = statuses.get("error", 0) == 0

    v["ladder_exercised"] = (tier.get("demoted_blocks", 0) > 0
                             and tier.get("promoted_blocks", 0) > 0)
    v["cross_replica_hit"] = tier.get("routed", 0) > 0

    # bit-identity across every repeat of the same prompt
    by_prompt: Dict[str, set] = {}
    for r in records:
        if r["status"] == "ok" and r.get("pkey"):
            by_prompt.setdefault(r["pkey"], set()).add(
                tuple(r.get("tokens") or ()))
    v["prompt_repeats"] = sum(1 for _ in by_prompt)
    v["tokens_bit_identical"] = (
        len(by_prompt) > 0
        and all(len(s) == 1 for s in by_prompt.values()))

    fired = [e for e in events if e.get("kind") == "chaos"]
    want = {(f.site, f.kind, f.peer) for f in plan.faults}
    got = {(e.get("site"), e.get("fault"), e.get("peer"))
           for e in fired}
    v["faults_fired"] = want <= got
    promote_corrupts = sum(
        1 for e in fired if e.get("site") == "kvtier.promote"
        and e.get("fault") == "corrupt")
    v["corrupt_caught"] = (
        promote_corrupts > 0
        and tier.get("corrupt_detected", 0) >= promote_corrupts
        and v["no_errors"])
    drops_fired = sum(1 for e in fired if e.get("fault") == "drop"
                      and str(e.get("site", "")).startswith("kvtier."))
    v["drops_degraded"] = (
        drops_fired > 0
        and (tier.get("demote_drops", 0)
             + tier.get("promote_drops", 0)) > 0
        and v["no_errors"])

    v["ok"] = all(v[k] is not False for k in (
        "no_silent_drops", "answered_once", "shed_carry_retry_after",
        "ladder_exercised", "cross_replica_hit",
        "tokens_bit_identical", "corrupt_caught", "drops_degraded",
        "no_errors", "faults_fired"))
    return v


def run_kvtier_soak(out_dir: Optional[str] = None, *,
                    replicas: int = 2, clients: int = 4,
                    seed: int = 0, plan=None, steps: int = 8,
                    suspect_s: float = DEFAULT_SUSPECT_S,
                    interval_s: float = DEFAULT_INTERVAL_S,
                    min_duration_s: float = 6.0,
                    max_duration_s: float = 60.0,
                    max_new_tokens: int = 4,
                    deadline_ms: float = 20000.0,
                    device: Optional[str] = None) -> dict:
    """The fleet-KV-tier soak: multi-turn conversations with a shared
    system prefix over an in-process fleet running the full tier —
    small pool + tiny host rings so prefix evictions DEMOTE down the
    ladder (one replica rings at 1 MiB for the host rung, one at 0 so
    every demotion spills to disk), returning turns PROMOTE back, the
    fleet index steers follow-ups at the holder — under the seeded
    ``kvtier`` chaos profile (corrupt demote + corrupt promote + drop
    both). Conversations replay deterministically (greedy decode,
    derived follow-up tokens), so every prompt repeats and the verdict
    can assert bit-identical tokens across cold/promoted/re-prefilled
    serves. ``device``: where the replicas run (None: the card). Returns
    the :func:`evaluate_kvtier` verdict; never raises on a failed
    invariant."""
    import shutil
    import tempfile

    import numpy as np

    from .._device import resolve_device
    from ..chaos import inject
    from ..chaos.plan import ChaosPlan, random_plan
    from .executor import ShardedExecutor
    from .fleet import FleetRouter, Replica
    from .queue import Rejected
    from .worker import tiny_gpt_builder

    if plan is None or plan == "random":
        resolved = random_plan(seed, replicas, steps, profile="kvtier")
    elif isinstance(plan, ChaosPlan):
        resolved = plan
    else:
        resolved = ChaosPlan.parse(str(plan))

    work = out_dir or tempfile.mkdtemp(prefix="hvd-kvtier-soak-")
    os.makedirs(work, exist_ok=True)

    # 16 blocks is UNDER one deep conversation pair (two 32-token
    # prompts need 18) — the admission gate must evict prefix runs
    # every wave, which is exactly the demotion pressure the ladder
    # soak exists to exercise
    dev = resolve_device(device)
    models = [tiny_gpt_builder(seed=seed, paged=True, kv_pool_blocks=16,
                               device=dev)["model"]
              for _ in range(replicas)]

    events: List[dict] = []
    records: List[dict] = []
    ev_lock = threading.Lock()
    rec_lock = threading.Lock()

    def log_event(kind: str, ev: dict) -> None:
        with ev_lock:
            events.append(dict(ev, kind=kind))

    reps = [
        Replica(i,
                ShardedExecutor(models[i], max_batch=4, max_len=48,
                                device=dev, replica_id=i),
                # conversations grow to 32 prompt tokens — the bucket
                # set must cover the deepest turn
                buckets=(16, 32), max_queue=max(32, 4 * clients),
                deadline_ms=deadline_ms, kv_crc=True,
                prefix_cache=True, kv_tier=True,
                # replica 0 spills straight to disk (0 MiB ring);
                # the others keep the host rung — both ladder rungs
                # are exercised in one soak
                kvtier_host_mb=(0 if i == 0 else 1),
                kvtier_dir=os.path.join(work, "spill", f"r{i}"))
        for i in range(replicas)]
    router = FleetRouter(reps, interval_s=interval_s,
                         suspect_s=suspect_s)
    router.add_listener(lambda ev: log_event("fleet", ev))

    inj = inject.install(resolved, rank=0)
    inj.add_listener(lambda ev: log_event(
        "chaos", {"fault": ev["kind"],
                  **{k: x for k, x in ev.items() if k != "kind"}}))

    router.start()
    stop = threading.Event()

    # one shared system prefix (2 full blocks) across EVERY client —
    # the cross-replica routing signal
    grng = np.random.RandomState(seed + 777)
    sys_prefix = [int(t) for t in grng.randint(1, 64, 8)]

    def client(cid: int) -> None:
        rng = np.random.RandomState(10_000 + cid)
        openers = [[int(t) for t in rng.randint(1, 64, 4)]
                   for _ in range(2)]
        conv = 0
        while not stop.is_set():
            prompt = list(sys_prefix) + openers[conv % 2]
            conv += 1
            while len(prompt) <= 32 and not stop.is_set():
                t0 = time.time()
                rec = {"fid": None, "t0": t0, "t1": None,
                       "status": "pending", "latency_ms": None,
                       "retry_after_ms": None, "resolutions": 0,
                       "replica": None, "client": cid,
                       "pkey": ",".join(map(str, prompt)),
                       "tokens": None}
                try:
                    h = router.submit(prompt,
                                      max_new_tokens=max_new_tokens)
                except Rejected as e:
                    rec.update(status="shed",
                               retry_after_ms=e.retry_after_ms,
                               t1=time.time())
                    with rec_lock:
                        records.append(rec)
                    time.sleep(min((e.retry_after_ms or 100.0), 500.0)
                               / 1000.0)
                    continue
                h.wait(timeout=deadline_ms / 1000.0 + 30.0)
                rec.update(fid=h.fid, t1=time.time(),
                           status=h.status, latency_ms=h.latency_ms,
                           retry_after_ms=h.retry_after_ms,
                           resolutions=h.resolutions,
                           replica=h.replica,
                           tokens=[int(t) for t in (h.tokens or ())])
                with rec_lock:
                    records.append(rec)
                if h.status != "ok":
                    break
                # the follow-up turn: generated tokens plus ONE derived
                # user token — deterministic, so conversation replays
                # repeat the exact prompts (the bit-identity probe)
                prompt = prompt + [int(t) for t in h.tokens] + [
                    (cid * 7 + len(prompt)) % 63 + 1]
                time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t_start = time.monotonic()
    for t in threads:
        t.start()

    want = {(f.site, f.kind, f.peer) for f in resolved.faults}

    def faults_all_fired() -> bool:
        with ev_lock:
            got = {(e.get("site"), e.get("fault"), e.get("peer"))
                   for e in events if e.get("kind") == "chaos"}
        return want <= got

    def tier_exercised() -> bool:
        promoted = sum(r.batcher.kvtier.promoted_blocks for r in reps
                       if r.batcher is not None
                       and r.batcher.kvtier is not None)
        return (promoted > 0
                and int(router._m_kvtier_routed.value) > 0)

    while time.monotonic() - t_start < max_duration_s:
        if faults_all_fired() and tier_exercised() \
                and time.monotonic() - t_start >= min_duration_s:
            break
        time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join(timeout=deadline_ms / 1000.0 + 35.0)

    fleet_stats = router.stats()
    tier: Dict[str, int] = {
        "demoted_blocks": 0, "promoted_blocks": 0, "demote_drops": 0,
        "promote_drops": 0, "corrupt_detected": 0, "pulls_in": 0,
        "host_runs": 0, "disk_runs": 0,
    }
    for r in reps:
        if r.batcher is None or r.batcher.kvtier is None:
            continue
        for k, val in r.batcher.kvtier.stats().items():
            if k in tier:
                tier[k] += int(val)
    tier["routed"] = int(router._m_kvtier_routed.value)
    tier["pulls"] = int(router._m_kvtier_pulls.value)
    tier["pull_corrupt"] = int(router.kvtier_pull_corrupt)
    if router.kvtier_index is not None:
        tier["index"] = router.kvtier_index.stats()
    router.close()
    inject.uninstall()

    verdict = evaluate_kvtier(
        records, sorted(events, key=lambda e: e.get("t", 0.0)),
        resolved, fleet_stats, tier)
    verdict.update({
        "seed": resolved.seed, "replicas": replicas,
        "clients": clients,
        "wall_s": round(time.monotonic() - t_start, 2),
        "plan": json.loads(resolved.to_json()),
        "fleet": fleet_stats,
    })
    if out_dir:
        with open(os.path.join(out_dir, "events.jsonl"), "w") as f:
            for e in events:
                f.write(json.dumps(e, default=str) + "\n")
        with open(os.path.join(out_dir, "requests.jsonl"), "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        with open(os.path.join(out_dir, "verdict.json"), "w") as f:
            json.dump(verdict, f, indent=2, sort_keys=True)
    else:
        shutil.rmtree(work, ignore_errors=True)
    return verdict
