"""PyTorch port: the serve soaks (``serve/soak.py``) against the reference.

* the five pure verdicts (``evaluate_serve``, ``evaluate_fleet``,
  ``evaluate_disagg``, ``evaluate_autoscale``, ``evaluate_kvtier``) on
  the same synthetic records, events, plans and fleet stats in both
  packages — a clean run and runs that break one invariant each — give
  equal verdicts, key for key;
* ``run_serve_soak`` on the CPU (two in-process replicas of the tiny
  paged GPT with the prefix cache, the crc ledger and speculative
  decoding at spec_k 3, four clients, a seeded serve-profile plan, a
  weight version published mid-incident through the real stream): its
  verdict is ok, every scheduled fault fired, and every replica ends on
  version 2;
* ``run_autoscale_soak`` refuses, naming ``ROADMAP.md`` item 13;
* marked ``slow``, as the reference marks its own soak acceptance: the
  process fleet's soak (``run_fleet_soak(replicas=2, clients=4,
  seed=7)``), the disaggregated soak (``run_disagg_soak(prefill=2,
  decode=1, seed=7)``) and the KV-tier soak, each with an ok verdict.
"""
import copy

import numpy as np
import pytest

from horovod_tpu.chaos.plan import ChaosPlan as JPlan
from horovod_tpu.serve import soak as jsoak
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos.plan import ChaosPlan as TPlan
from horovod_tpu_torch.serve import soak as tsoak

_SLO = dict(suspect_s=1.0, slo_p99_ms=500.0, slo_error_rate=0.05,
            recovery_window_s=2.0)


def _records(n=60, seed=0, t_start=100.0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t0 = t_start + 0.25 * i
        lat = float(rng.uniform(20.0, 200.0))
        out.append({"fid": i, "t0": t0, "t1": t0 + lat / 1000.0,
                    "status": "ok", "latency_ms": lat,
                    "retry_after_ms": None, "resolutions": 1,
                    "replica": i % 2, "client": i % 4,
                    "pkey": f"p{i % 7}",
                    "tokens": [int(i % 7), 3, 4]})
    # two sheds with their hint, one expired request inside a window
    out += [{"fid": None, "t0": 102.0, "t1": 102.0, "status": "shed",
             "latency_ms": None, "retry_after_ms": 250.0,
             "resolutions": 0, "replica": None, "client": 1},
            {"fid": 90, "t0": 103.1, "t1": 103.4, "status": "rejected",
             "latency_ms": None, "retry_after_ms": 100.0,
             "resolutions": 1, "replica": 0, "client": 2},
            {"fid": 91, "t0": 103.2, "t1": 104.0, "status": "expired",
             "latency_ms": 800.0, "retry_after_ms": None,
             "resolutions": 1, "replica": 1, "client": 3}]
    return out


def _plan(kind):
    faults = {
        "serve": [
            {"rank": 0, "site": "serve.step", "kind": "crash", "peer": 1,
             "at": 40},
            {"rank": 0, "site": "serve.kv", "kind": "corrupt", "peer": 0,
             "at": 60},
            {"rank": 0, "site": "serve.route", "kind": "partition",
             "peer": 0, "at": 20, "seconds": 0.5}],
        "fleet": [
            {"rank": 0, "site": "serve.proc", "kind": "crash", "peer": 1,
             "at": 40, "epoch": 0},
            {"rank": 0, "site": "serve.dispatch", "kind": "conn_reset",
             "peer": 0, "at": 5},
            {"rank": 0, "site": "serve.dispatch", "kind": "flaky",
             "peer": 0, "after": 10, "until": 30, "prob": 0.5}],
        "disagg": [
            {"rank": 0, "site": "serve.proc", "kind": "crash", "peer": 0,
             "at": 40, "epoch": 0},
            {"rank": 0, "site": "serve.migrate", "kind": "corrupt",
             "at": 3},
            {"rank": 0, "site": "serve.migrate", "kind": "conn_reset",
             "at": 7}],
        "autoscale": [
            {"rank": 0, "site": "autoscale.scale", "kind": "crash",
             "at": 0},
            {"rank": 0, "site": "autoscale.scale", "kind": "drop",
             "at": 1}],
        "kvtier": [
            {"rank": 0, "site": "kvtier.promote", "kind": "corrupt",
             "peer": 1, "at": 2},
            {"rank": 0, "site": "kvtier.demote", "kind": "drop",
             "peer": 0, "at": 3}],
    }[kind]
    return {"seed": 7, "faults": faults}


def _events(kind, *, eject_after=0.2, readmit_version=2, fired=True):
    crash_peer = 0 if kind == "disagg" else 1
    ev = []
    for f in _plan(kind)["faults"] if fired else ():
        ev.append({"kind": "chaos", "fault": f["kind"], "site": f["site"],
                   "peer": f.get("peer"), "t": 105.0})
    if kind in ("serve", "fleet", "disagg"):
        ev += [{"kind": "fleet", "event": "eject", "replica": crash_peer,
                "t": 105.0 + eject_after},
               {"kind": "fleet", "event": "readmit", "replica": crash_peer,
                "weights_version": readmit_version, "t": 108.0}]
    if kind == "autoscale":
        for pool in ("prefill", "decode"):
            ev += [{"kind": "scale", "pool": pool, "direction": "up",
                    "ok": True, "weights_version": 2, "t": 106.0},
                   {"kind": "scale", "pool": pool, "direction": "down",
                    "ok": True, "t": 109.0}]
    return sorted(ev, key=lambda e: e["t"])


def _stats(replicas=2, versions=(2, 2), **extra):
    s = {"inflight": 0, "replicas_up": replicas, "failovers": 1,
         "respawns": 1, "duplicates_suppressed": 0,
         "replicas": {str(i): {"weights_version": v}
                      for i, v in enumerate(versions)}}
    s.update(extra)
    return s


def _traces(records):
    out = [{"rid": r["fid"], "status": r["status"],
            "e2e_ms": r["latency_ms"] or 10.0,
            "legs_ms": {"prefill": 0.4 * (r["latency_ms"] or 10.0),
                        "decode": 0.6 * (r["latency_ms"] or 10.0)}}
           for r in records if r.get("fid") is not None]
    return out + [{"rid": None, "status": "shed", "e2e_ms": 0.0,
                   "legs_ms": {}}]


def _case(evaluator, variant):
    """(args, kwargs) of one evaluator call: a clean run, or one broken
    invariant (``variant``)."""
    kind = {"evaluate_serve": "serve", "evaluate_fleet": "fleet",
            "evaluate_disagg": "disagg",
            "evaluate_autoscale": "autoscale",
            "evaluate_kvtier": "kvtier"}[evaluator]
    records = _records()
    ev_kw, stats = {}, _stats()
    if variant == "late_eject":
        ev_kw["eject_after"] = 5.0
    if variant == "stale_readmit":
        ev_kw["readmit_version"] = 1
    if variant == "unfired":
        ev_kw["fired"] = False
    if variant == "pending":
        records[3]["status"] = "pending"
    if variant == "twice":
        records[5]["resolutions"] = 2
    if variant == "shed_no_hint":
        records[-3]["retry_after_ms"] = None
    if variant == "slow_p99":
        for r in records[:40]:
            r["latency_ms"] = 900.0
    if variant == "few_samples":
        records = records[:10]
    if variant == "stale_replica":
        stats = _stats(versions=(2, 1))
    if variant == "blip_escalated":
        stats = _stats(failovers=2)
    if variant == "tokens_differ":
        records[7]["tokens"] = [9, 9, 9]
    events = _events(kind, **ev_kw)
    plan = _plan(kind)
    slo = dict(_SLO)
    if evaluator == "evaluate_serve":
        return (records, events, plan, stats), dict(
            slo, replicas=2, newest_version=2,
            kv_injected=0 if variant == "kv_missed" else 1,
            kv_detected=0 if variant == "kv_missed" else 1)
    if evaluator == "evaluate_fleet":
        return (records, events, plan, stats), dict(
            slo, replicas=2, newest_version=2,
            dispatch_absorbed=0 if variant == "no_absorb" else 3,
            dedupe_hits=0 if variant == "no_dedupe" else 1)
    if evaluator == "evaluate_disagg":
        traces = _traces(records)
        if variant == "missing_trace":
            traces = [t for t in traces if t["rid"] != 91]
        if variant == "legs_off":
            for t in traces:
                t["legs_ms"] = {k: 2 * v for k, v in t["legs_ms"].items()}
        return (records, events, plan, stats), dict(
            slo, replicas=2, newest_version=2,
            migrations_in=0 if variant == "no_migrations" else 12,
            migrate_absorbed=1, migrate_corrupt_detected=1, reprefills=1,
            traces=traces, trace_slow_ms=700.0)
    if evaluator == "evaluate_autoscale":
        if variant == "never_down":
            events = [e for e in events if not (
                e["kind"] == "scale" and e["pool"] == "decode"
                and e["direction"] == "down")]
        stats = {"inflight": 0, "duplicates_suppressed": 0,
                 "prefill": {"replicas_up": 1},
                 "decode": {"replicas_up": 2 if variant == "at_ceiling"
                            else 1},
                 "replicas": {"0": {"weights_version": 2},
                              "1": {"weights_version": 2}}}
        return (records, events, plan, stats), dict(
            slo_p99_ms=_SLO["slo_p99_ms"],
            slo_error_rate=_SLO["slo_error_rate"],
            recovery_window_s=_SLO["recovery_window_s"],
            newest_version=2, min_per_pool=1)
    tier = {"demoted_blocks": 4, "promoted_blocks": 2, "demote_drops": 1,
            "promote_drops": 0, "corrupt_detected": 1, "routed": 3,
            "pulls": 1}
    if variant == "ladder_still":
        tier["promoted_blocks"] = 0
    return (records, events, plan, stats, tier), {}


_CASES = [
    ("evaluate_serve", v) for v in (
        "clean", "late_eject", "pending", "twice", "shed_no_hint",
        "slow_p99", "few_samples", "stale_replica", "kv_missed",
        "unfired")] + [
    ("evaluate_fleet", v) for v in (
        "clean", "blip_escalated", "no_absorb", "no_dedupe",
        "stale_readmit")] + [
    ("evaluate_disagg", v) for v in (
        "clean", "no_migrations", "missing_trace", "legs_off",
        "stale_readmit")] + [
    ("evaluate_autoscale", v) for v in (
        "clean", "never_down", "at_ceiling", "unfired")] + [
    ("evaluate_kvtier", v) for v in (
        "clean", "tokens_differ", "ladder_still", "unfired")]


@pytest.mark.parametrize("evaluator,variant", _CASES)
def test_verdicts_equal_the_reference(evaluator, variant):
    args, kw = _case(evaluator, variant)
    verdicts = []
    for mod, Plan in ((jsoak, JPlan), (tsoak, TPlan)):
        a = list(copy.deepcopy(args))
        a[2] = Plan.from_dict(a[2])
        verdicts.append(getattr(mod, evaluator)(*a, **copy.deepcopy(kw)))
    assert verdicts[0] == verdicts[1]
    assert verdicts[1]["ok"] is (variant == "clean")


def test_resolve_plan_and_constants_equal_the_reference():
    for name in ("DEFAULT_REPLICAS", "DEFAULT_CLIENTS", "DEFAULT_STEPS",
                 "DEFAULT_SUSPECT_S", "DEFAULT_INTERVAL_S",
                 "DEFAULT_SLO_P99_MS", "DEFAULT_SLO_ERROR_RATE",
                 "DEFAULT_RECOVERY_WINDOW_S", "_DISRUPTIVE",
                 "FLEET_SUSPECT_S"):
        assert getattr(tsoak, name) == getattr(jsoak, name), name
    for plan in (None, "random"):
        assert tsoak._resolve_plan(plan, 7, 3, 240).to_json() == \
            jsoak._resolve_plan(plan, 7, 3, 240).to_json()
    spec = _plan("serve")
    p = tsoak._resolve_plan(TPlan.from_dict(spec), 0, 3, 240)
    assert p.to_json() == tsoak._resolve_plan(p.to_json(), 0, 3,
                                              240).to_json()


def test_autoscale_soak_waits_for_item_13():
    with pytest.raises(NotImplementedError, match="item 13"):
        tsoak.run_autoscale_soak(device="cpu")


def test_serve_soak_on_the_cpu(tmp_path, monkeypatch):
    """The in-process soak (spec_k 3, paged KV with the prefix cache and
    the crc ledger, its defaults) over the real weight stream, at 2
    replicas and 4 clients, the plan's horizon at 40 scheduler
    iterations so this CPU lands every fault in seconds, and 3 s
    recovery windows (fewer requests excused from the SLO than the
    default 6 s); the card runs it at its defaults (``chip_smoke.py``
    phase 21)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    try:
        v = tsoak.run_serve_soak(str(tmp_path), replicas=2, clients=4,
                                 steps=40, recovery_window_s=3.0,
                                 device="cpu")
    finally:
        tinject.uninstall()
    want = {(f["site"], f["kind"], f.get("peer"))
            for f in v["plan"]["faults"]}
    assert want and v["ok"] is True, {k: x for k, x in v.items()
                                      if k not in ("plan", "fleet")}
    for k in ("no_silent_drops", "answered_once", "kv_containment",
              "failover_bounded", "slo_held", "capacity_restored"):
        assert v[k] is True, k
    assert v["kv_injected"] >= 1 and v["kv_detected"] >= v["kv_injected"]
    assert v["clean_ok_samples"] >= 20
    assert {r["weights_version"] for r in v["fleet"]["replicas"].values()} \
        == {2}
    assert v["spec_k"] == 3 and v["paged"] is True
    assert (tmp_path / "verdict.json").exists()


@pytest.mark.slow
def test_fleet_soak_acceptance(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    v = tsoak.run_fleet_soak(str(tmp_path), replicas=2, clients=4, seed=7,
                             device="cpu")
    detail = {k: x for k, x in v.items() if k not in ("plan", "fleet")}
    for k in ("no_silent_drops", "answered_once", "shed_carry_retry_after",
              "failover_bounded", "blips_absorbed", "failovers_only_kills",
              "replays_deduped", "respawned_on_newest", "capacity_restored",
              "slo_held", "ok"):
        assert v[k] is True, (k, detail)
    assert v["fleet"]["failovers"] == 1 and v["fleet"]["respawns"] == 1


@pytest.mark.slow
def test_disagg_soak_acceptance(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    v = tsoak.run_disagg_soak(str(tmp_path), prefill=2, decode=1, seed=7,
                              device="cpu")
    detail = {k: x for k, x in v.items() if k not in ("plan", "fleet")}
    for k in ("no_silent_drops", "answered_once", "failover_bounded",
              "migrations_ok", "migrate_corrupt_caught",
              "failovers_only_kills", "respawned_on_newest",
              "traces_complete", "ok"):
        assert v[k] is True, (k, detail)
    assert (tmp_path / "trace.json").exists()


@pytest.mark.slow
def test_kvtier_soak_acceptance(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    v = tsoak.run_kvtier_soak(device="cpu")
    detail = {k: x for k, x in v.items() if k not in ("plan", "fleet")}
    for k in ("no_silent_drops", "answered_once", "ladder_exercised",
              "cross_replica_hit", "tokens_bit_identical", "corrupt_caught",
              "drops_degraded", "no_errors", "faults_fired", "ok"):
        assert v[k] is True, (k, detail)
