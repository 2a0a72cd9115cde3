"""Declarative, seeded fault plans.

The port's copy of ``horovod_tpu/chaos/plan.py``, whole: the same
kinds, sites, fail-fast parser and ``random_plan`` profiles, so the same
JSON or seed gives the same plan in both packages (stdlib only).

A plan is JSON — inline in ``HOROVOD_CHAOS_PLAN`` or a file path — of
the shape::

    {"seed": 1234,
     "faults": [
       {"rank": 1, "site": "step",          "at": 5, "kind": "crash"},
       {"rank": 3, "site": "step",          "kind": "slow_rank",
        "seconds": 0.05, "after": 2, "until": 6},
       {"rank": 2, "site": "store.request", "at": 7, "kind": "delay",
        "seconds": 0.2},
       {"rank": 0, "site": "p2p.send",      "at": 3, "kind": "drop"},
       {"rank": 0, "site": "p2p.send",      "at": 2, "kind": "corrupt"},
       {"rank": 0, "site": "p2p.send",      "at": 1, "kind": "partition",
        "peer": 1, "seconds": 3.0},
       {"rank": 0, "site": "ckpt.write",    "at": 0, "kind": "torn_write"},
       {"rank": 0, "site": "ckpt.commit",   "at": 1, "kind": "delete_chunk",
        "shard": 2, "epoch": 0}]}

Addressing: every fault names the (process) ``rank`` it fires on, the
``site`` it lands at, and WHEN — ``at`` matches exactly the N-th
invocation of that site on that rank (for ``site: "step"`` N is the
training step the application reports via ``chaos.step_boundary``), or
an ``after``/``until`` window, or always when neither is given.
``epoch`` (optional) pins a fault to one elastic incarnation
(HOROVOD_CKPT_RESET_EPOCH — the elastic launcher increments it per
reset), so a crash scheduled in epoch 0 does not re-fire after the
relaunch.

Sites are the REAL wire/disk boundaries the injection shims wrap
(inject.py); kinds are validated against the sites they make sense at.
Parsing is fail-fast: unknown keys, kinds, sites, or missing kind
parameters raise :class:`PlanError` at startup, never mid-run.

Determinism: a plan is a pure value; :func:`random_plan` derives one
from a seed via ``random.Random(seed)`` only — same seed, same world,
same steps => byte-identical plan.
"""
from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field
from typing import List, Optional

FAULT_KINDS = ("delay", "drop", "crash", "corrupt", "partition",
               "slow_rank", "torn_write", "delete_chunk",
               # TRANSIENT kinds (the retry-ladder's subjects — blips
               # the wire plane must absorb without an elastic reset):
               # conn_reset REALLY closes the live connection once and
               # then heals (the reconnect ladder re-dials and
               # resumes); flaky drops messages with seeded probability
               # 'prob' inside an after/until window; jitter sleeps a
               # seeded random duration in (0, seconds] per crossing.
               "conn_reset", "flaky", "jitter")

FAULT_SITES = ("step", "store.request", "p2p.send", "p2p.recv",
               "ckpt.write", "ckpt.read", "ckpt.commit",
               "redist.transport",
               # serve plane (horovod_tpu/serve): faults address a
               # REPLICA via the "peer" field (the serving process is
               # the plan's "rank"); "at"/"after"/"until" count that
               # replica's own scheduler iterations (serve.step /
               # serve.kv), its router dispatches (serve.route) or its
               # queue submits (serve.admit) — the guards pass the
               # replica-local counter explicitly, so addressing stays
               # deterministic per replica across the whole fleet.
               "serve.step", "serve.kv", "serve.route", "serve.admit",
               # multi-process fleet (serve/proc_fleet.py): serve.proc
               # fires inside the REPLICA WORKER PROCESS at its own
               # scheduler-iteration boundary — crash there is a REAL
               # os.kill(SIGKILL) of the worker, the host-loss scenario
               # the accrual heartbeat sweep must detect; serve.dispatch
               # fires in the ROUTER process on its wire to one replica
               # (peer), where conn_reset/flaky sever the live dispatch
               # socket and the native/resilience.py ladder must absorb
               # the blip WITHOUT a failover.
               "serve.proc", "serve.dispatch",
               # disaggregated serving (serve/disagg.py +
               # serve/kv_migrate.py): serve.migrate fires in the
               # PREFILL worker process on its KV-block push to one
               # decode replica (peer = the decode replica id;
               # "at"/"after"/"until" count that worker's own migration
               # attempts). conn_reset severs the migration socket
               # AFTER the kv_install frame landed (the decode side
               # installed; the ladder replay must be served the
               # deduped install ack), corrupt flips one payload bit
               # BEFORE framing so the per-block crc ledger — not the
               # frame crc — must catch it on arrival, drop loses the
               # push before it is sent, delay sleeps.
               "serve.migrate",
               # autoscale control plane (horovod_tpu/autoscale): fires
               # in the ACTUATOR (router process, plan rank 0) at each
               # APPLIED scale event — "at"/"after"/"until" count scale
               # events, not iterations. crash kills the newcomer worker
               # mid-warmup (admission must fail loudly and retry the
               # spawn; live traffic is untouched because the newcomer
               # was never admitted); delay stalls the actuator between
               # spawn and the weight-stream admission gate (the gate
               # must still refuse a stale-version newcomer); drop turns
               # a graceful scale-down drain into a hard kill, so the
               # parked-row/eject machinery must still answer every
               # in-flight sequence exactly once.
               "autoscale.scale",
               # fleet KV tier (serve/kvtier/): kvtier.demote fires on
               # the REPLICA's scheduler thread as a refcount-zero
               # prefix run demotes down the ladder ("at"/"after"/
               # "until" count that replica's demotion ops) — drop
               # skips the demotion (the run dies; a follow-up
               # re-prefills, the miss path), corrupt flips one bit in
               # the demoted copy AFTER its crc ledger is stamped so
               # only the promote-side crc gate can catch it.
               # kvtier.promote fires as a ladder-held run is promoted
               # back toward HBM (counting promotion ops) — drop loses
               # the promotion (re-prefill fallback, never an error),
               # corrupt flips a bit in the bytes about to be verified,
               # which the crc gate must refuse BEFORE any device byte
               # lands.
               "kvtier.demote", "kvtier.promote")

#: which kinds are meaningful at which sites (a drop needs a connection
#: to sever; a torn write needs a shard file; a KV corruption needs a
#: cache slot; ...)
_KIND_SITES = {
    "delay": FAULT_SITES,
    "slow_rank": ("step", "serve.step", "serve.proc"),
    # serve-plane crashes land ONLY where a guard acts on them:
    # serve.step (the scheduler loop raises ReplicaDead — the
    # in-process replica-loss analog) and serve.proc (the worker
    # PROCESS guard SIGKILLs itself — the real host loss of the
    # multi-process fleet). At the other serve sites no guard acts on
    # a returned crash, so validating it there would let fire() record
    # a "crash" that kills nothing — a soak could then prove recovery
    # from a death that never happened. (autoscale.scale qualifies: the
    # actuator IS the guard — it SIGKILLs the newcomer it just spawned.
    # kvtier.* sites are tier moves, not processes — nothing to crash.)
    "crash": tuple(s for s in FAULT_SITES
                   if not s.startswith(("serve.", "kvtier."))) + (
                       "serve.step", "serve.proc"),
    "drop": ("store.request", "p2p.send", "p2p.recv",
             "redist.transport", "serve.admit", "serve.migrate",
             # drop at a scale event = the graceful drain is dropped
             # (hard kill instead), exercising the eject/requeue path
             "autoscale.scale",
             # drop at a tier move = the move is lost, the run
             # re-prefills on next use — the miss path, never an error
             "kvtier.demote", "kvtier.promote"),
    "corrupt": ("store.request", "p2p.send", "redist.transport",
                "serve.kv", "serve.migrate",
                # corrupt at a tier move = one flipped bit the per-leaf
                # crc gate must catch before any device byte lands
                "kvtier.demote", "kvtier.promote"),
    "partition": ("store.request", "p2p.send", "p2p.recv",
                  "redist.transport", "serve.route"),
    "torn_write": ("ckpt.write",),
    "delete_chunk": ("ckpt.commit",),
    # transient kinds land only where a retry ladder exists to absorb
    # them: the store/coordinator client, the p2p ring, redist's wire
    # transports, and the fleet router's dispatch channel
    "conn_reset": ("store.request", "p2p.send", "p2p.recv",
                   "redist.transport", "serve.dispatch",
                   "serve.migrate"),
    "flaky": ("store.request", "p2p.send", "p2p.recv",
              "redist.transport", "serve.dispatch", "serve.migrate"),
    "jitter": ("store.request", "p2p.send", "p2p.recv",
               "redist.transport", "serve.dispatch"),
}

#: kinds that require a positive "seconds" duration
_NEEDS_SECONDS = ("delay", "slow_rank", "partition", "jitter")

_FIELDS = {"rank", "site", "kind", "at", "after", "until", "seconds",
           "peer", "shard", "slot", "epoch", "prob"}


class PlanError(ValueError):
    """Malformed chaos plan — raised at parse time, fail-fast."""


@dataclass
class Fault:
    """One scheduled fault. See the module docstring for semantics."""

    rank: int
    site: str
    kind: str
    at: Optional[int] = None
    after: Optional[int] = None
    until: Optional[int] = None
    seconds: Optional[float] = None
    peer: Optional[int] = None
    shard: Optional[int] = None
    #: serve.kv corrupt only: the KV slot (slotted layout) or batch
    #: row (paged layout — the flip lands in that row's newest block)
    #: to hit; default: the lowest live slot/row at fire time
    slot: Optional[int] = None
    epoch: Optional[int] = None
    #: flaky only: per-crossing drop probability in (0, 1], drawn from
    #: the injector's seeded rng — same seed, same drop pattern
    prob: Optional[float] = None

    def validate(self) -> "Fault":
        if not isinstance(self.rank, int) or self.rank < 0:
            raise PlanError(f"fault rank must be a non-negative int; "
                            f"got {self.rank!r}")
        if self.site not in FAULT_SITES:
            raise PlanError(f"unknown fault site {self.site!r} "
                            f"(one of {FAULT_SITES})")
        if self.kind not in FAULT_KINDS:
            raise PlanError(f"unknown fault kind {self.kind!r} "
                            f"(one of {FAULT_KINDS})")
        if self.site not in _KIND_SITES[self.kind]:
            raise PlanError(
                f"fault kind {self.kind!r} cannot land at site "
                f"{self.site!r} (valid sites: {_KIND_SITES[self.kind]})")
        if self.at is not None and (self.after is not None
                                    or self.until is not None):
            raise PlanError(
                "a fault schedules either an exact 'at' or an "
                "'after'/'until' window, not both")
        for name in ("at", "after", "until", "peer", "shard", "slot",
                     "epoch"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v < 0):
                raise PlanError(
                    f"fault field {name!r} must be a non-negative int; "
                    f"got {v!r}")
        if self.after is not None and self.until is not None \
                and self.until < self.after:
            raise PlanError(
                f"fault window empty: until={self.until} < "
                f"after={self.after}")
        if self.kind in _NEEDS_SECONDS:
            s = self.seconds
            if not isinstance(s, (int, float)) or not (0 < s <= 3600):
                raise PlanError(
                    f"fault kind {self.kind!r} needs 'seconds' in "
                    f"(0, 3600]; got {s!r}")
        if self.kind == "delete_chunk" and self.shard is None:
            raise PlanError(
                "fault kind 'delete_chunk' needs 'shard' (the rank "
                "whose committed shard file to delete)")
        if self.kind == "flaky":
            p = self.prob
            if not isinstance(p, (int, float)) or not (0 < p <= 1):
                raise PlanError(
                    f"fault kind 'flaky' needs 'prob' in (0, 1] (the "
                    f"seeded per-message drop probability); got {p!r}")
        elif self.prob is not None:
            raise PlanError(
                f"fault field 'prob' only applies to kind 'flaky'; "
                f"got kind {self.kind!r}")
        if self.slot is not None and self.site != "serve.kv":
            raise PlanError(
                f"fault field 'slot' only addresses KV slots at site "
                f"'serve.kv'; got site {self.site!r}")
        return self

    def matches(self, n: int, epoch: int) -> bool:
        """Does this fault fire at the site's n-th invocation (or step
        n) in elastic incarnation ``epoch``?"""
        if self.epoch is not None and self.epoch != epoch:
            return False
        if self.at is not None:
            return n == self.at
        if self.after is not None and n < self.after:
            return False
        if self.until is not None and n > self.until:
            return False
        return True

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if v is not None}


@dataclass
class ChaosPlan:
    """A validated set of faults plus the seed that derives any
    injection-time randomness (corrupt bit positions)."""

    seed: int = 0
    faults: List[Fault] = field(default_factory=list)

    @staticmethod
    def from_dict(obj: dict) -> "ChaosPlan":
        if not isinstance(obj, dict):
            raise PlanError(f"chaos plan must be a JSON object; "
                            f"got {type(obj).__name__}")
        unknown = set(obj) - {"seed", "faults"}
        if unknown:
            raise PlanError(f"unknown chaos plan keys {sorted(unknown)} "
                            f"(expected 'seed', 'faults')")
        seed = obj.get("seed", 0)
        if not isinstance(seed, int):
            raise PlanError(f"chaos plan seed must be an int; got {seed!r}")
        raw = obj.get("faults", [])
        if not isinstance(raw, list):
            raise PlanError("chaos plan 'faults' must be a list")
        faults = []
        for i, f in enumerate(raw):
            if not isinstance(f, dict):
                raise PlanError(f"fault #{i} must be an object; got {f!r}")
            bad = set(f) - _FIELDS
            if bad:
                raise PlanError(
                    f"fault #{i} has unknown fields {sorted(bad)} "
                    f"(expected a subset of {sorted(_FIELDS)})")
            missing = {"rank", "site", "kind"} - set(f)
            if missing:
                raise PlanError(
                    f"fault #{i} missing required fields "
                    f"{sorted(missing)}")
            try:
                faults.append(Fault(**f).validate())
            except PlanError as e:
                raise PlanError(f"fault #{i}: {e}") from None
        return ChaosPlan(seed=seed, faults=faults)

    @staticmethod
    def from_json(text: str) -> "ChaosPlan":
        try:
            obj = json.loads(text)
        except ValueError as e:
            raise PlanError(f"chaos plan is not valid JSON: {e}") from None
        return ChaosPlan.from_dict(obj)

    @staticmethod
    def parse(spec: str) -> "ChaosPlan":
        """HOROVOD_CHAOS_PLAN semantics: inline JSON when the value
        starts with '{', otherwise a path to a JSON file."""
        spec = spec.strip()
        if spec.startswith("{"):
            return ChaosPlan.from_json(spec)
        try:
            with open(spec) as f:
                text = f.read()
        except OSError as e:
            raise PlanError(
                f"HOROVOD_CHAOS_PLAN names a file that cannot be read "
                f"({spec!r}): {e}") from None
        return ChaosPlan.from_json(text)

    @staticmethod
    def from_env() -> Optional["ChaosPlan"]:
        # knob: exempt (config.validate() delegates its fail-fast parse
        # HERE — the chaos plane is stdlib-only and routing this read
        # back through Config would cycle)
        spec = os.environ.get("HOROVOD_CHAOS_PLAN")
        if not spec:
            return None
        return ChaosPlan.parse(spec)

    def for_rank(self, rank: int) -> List[Fault]:
        return [f for f in self.faults if f.rank == rank]

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [f.to_dict() for f in self.faults]},
                          sort_keys=True)


def random_plan(seed: int, world: int, steps: int, *,
                commit_every: int = 2, crash: bool = True,
                shard_delete: bool = True, noise: int = 2,
                profile: str = "train",
                processes: bool = False,
                prefill: Optional[int] = None) -> ChaosPlan:
    """A randomized-but-SEEDED soak plan: same (seed, world, steps,
    profile) => byte-identical schedule.

    ``profile="train"`` (default) composes the training acceptance
    scenario — one worker SIGKILLed mid-step in epoch 0, one committed
    ckpt shard deleted right after the last commit preceding the crash
    (so the relaunched job must restore that commit through the
    buddy-replica path) — plus ``noise`` benign delay/slow faults
    sprinkled across ranks and sites.

    ``profile="transient"`` composes the BLIP scenario the retry ladder
    must absorb with ZERO elastic resets (docs/elastic.md): connection
    resets on the p2p ring and the store client, a seeded flaky window
    on the ring, and request jitter — no crash, no shard delete. The
    transient soak asserts the run finishes bit-identical to a
    fault-free run with ``hvd_net_retries_total > 0`` and the recovery
    counters flat.

    ``profile="serve"`` composes the serving acceptance scenario over a
    ``world``-replica fleet (docs/serving.md): one replica crashed
    mid-decode, a second partitioned from the router, a KV slot
    corrupted on a third, one replica slowed past the suspect
    threshold, and an admission-queue drop — ``steps`` is the scheduler
    iteration horizon the crash/corrupt addresses land inside. All
    serve faults fire on plan rank 0 (the serving process) and address
    replicas via ``peer``. With ``processes=True`` the composition
    becomes the MULTI-PROCESS fleet scenario (serve/proc_fleet.py):
    one replica worker process SIGKILLed mid-traffic (``serve.proc``
    crash — a real host loss the accrual heartbeat sweep must detect
    and respawn from), a hard ``conn_reset`` plus a seeded ``flaky``
    window on surviving replicas' DISPATCH channels (``serve.dispatch``
    — blips the retry ladder must absorb with ZERO failovers), and an
    admission-queue drop absorbed by router re-dispatch.

    ``profile="autoscale"`` composes the scale-event scenario
    (docs/autoscale.md): a newcomer SIGKILLed mid-warmup, the actuator
    delayed past the weight-stream admission gate, and a scale-down
    drain dropped — here ``steps`` is the SCALE-EVENT horizon (the
    actuator counts applied scale events, not iterations) and
    ``world`` is unused. The soak verdict asserts exactly-once answers
    through every faulted scale event.

    ``profile="kvtier"`` composes the fleet-KV-tier scenario
    (docs/serving.md) over a ``world``-replica fleet: one replica's
    demotion corrupted (a bit flipped AFTER the crc ledger is stamped —
    the promote-side crc gate must catch it before any device byte
    lands), one promotion corrupted pre-verify (same gate), one
    demotion and one promotion dropped (the run dies / the promotion is
    lost — both degrade to re-prefill, never an error). ``steps`` is
    the TIER-OP horizon (each replica counts its own demote/promote
    ops).
    """
    if profile == "disagg":
        if prefill is None:
            prefill = max(world - 1, 1)
        return _random_disagg_plan(seed, prefill, world - prefill,
                                   steps)
    if prefill is not None:
        raise PlanError(
            f"random_plan prefill= names the disagg profile's prefill "
            f"pool size; got profile {profile!r}")
    if profile == "serve":
        return _random_serve_plan(seed, world, steps,
                                  processes=processes)
    if processes:
        raise PlanError(
            f"random_plan processes=True is a serve-profile "
            f"composition; got profile {profile!r}")
    if profile == "transient":
        return _random_transient_plan(seed, world, steps)
    if profile == "autoscale":
        return _random_autoscale_plan(seed, steps)
    if profile == "kvtier":
        return _random_kvtier_plan(seed, world, steps)
    if profile != "train":
        raise PlanError(
            f"random_plan profile must be 'train', 'transient', "
            f"'serve', 'disagg', 'autoscale' or 'kvtier'; got "
            f"{profile!r}")
    if world < 2:
        raise PlanError(f"random_plan needs world >= 2; got {world}")
    if steps < 2 * commit_every + 2:
        raise PlanError(
            f"random_plan needs steps >= {2 * commit_every + 2} so a "
            f"commit precedes the crash; got {steps}")
    rng = random.Random(seed)
    faults: List[Fault] = []
    crash_step = None
    if crash:
        victim = rng.randrange(1, world)
        # crash strictly after the first commit and before the last step
        crash_step = rng.randrange(commit_every + 1, steps - 1)
        faults.append(Fault(rank=victim, site="step", at=crash_step,
                            kind="crash", epoch=0))
    if shard_delete:
        # the commit the relaunch will restore from: the last one
        # before the crash (or the first commit in a crash-free plan)
        n_commits = (crash_step // commit_every) if crash_step is not None \
            else 1
        faults.append(Fault(rank=0, site="ckpt.commit",
                            at=max(n_commits - 1, 0), kind="delete_chunk",
                            shard=rng.randrange(world), epoch=0))
    for _ in range(noise):
        kind = rng.choice(("delay", "slow_rank"))
        if kind == "slow_rank":
            a = rng.randrange(0, max(steps - 2, 1))
            faults.append(Fault(
                rank=rng.randrange(world), site="step", kind="slow_rank",
                seconds=round(rng.uniform(0.01, 0.05), 3),
                after=a, until=a + rng.randrange(1, 3)))
        else:
            faults.append(Fault(
                rank=rng.randrange(world),
                site=rng.choice(("store.request", "p2p.send")),
                kind="delay", at=rng.randrange(0, 20),
                seconds=round(rng.uniform(0.01, 0.1), 3)))
    for f in faults:
        f.validate()
    return ChaosPlan(seed=seed, faults=faults)


def _random_transient_plan(seed: int, world: int, steps: int) -> ChaosPlan:
    """The ``profile="transient"`` leg of :func:`random_plan`: blips
    only — every fault is one the retry/reconnect/backoff ladder must
    absorb in milliseconds, so the soak can assert ZERO elastic resets
    and bit-identical final params.

    Resets land at ``p2p.send`` (a close() delivers queued bytes + FIN,
    so the receiver's committed offset is exact and the resume loses
    nothing) and ``store.request``; addressing is in site-invocation
    counters, sized for the soak worker's ~12 ring crossings per step.
    """
    if world < 2:
        raise PlanError(
            f"a transient plan needs world >= 2 (a lone rank has no "
            f"wire to blip); got {world}")
    if steps < 6:
        raise PlanError(
            f"a transient plan needs steps >= 6 so blips land "
            f"mid-run; got {steps}")
    rng = random.Random(seed)
    a = rng.randrange(30, 60)
    b = rng.randrange(4, 10)
    faults = [
        # two hard connection resets on the ring, different ranks/times
        Fault(rank=rng.randrange(world), site="p2p.send",
              kind="conn_reset", at=rng.randrange(8, 30)),
        Fault(rank=rng.randrange(world), site="p2p.send",
              kind="conn_reset", at=rng.randrange(60, 100)),
        # one reset on the store/coordinator client
        Fault(rank=rng.randrange(world), site="store.request",
              kind="conn_reset", at=rng.randrange(4, 24)),
        # a flaky window on the ring: seeded per-message drops
        Fault(rank=rng.randrange(world), site="p2p.send", kind="flaky",
              prob=round(rng.uniform(0.3, 0.5), 2),
              after=a, until=a + rng.randrange(4, 8)),
        # request jitter on the store
        Fault(rank=rng.randrange(world), site="store.request",
              kind="jitter", seconds=round(rng.uniform(0.02, 0.05), 3),
              after=b, until=b + rng.randrange(4, 8)),
    ]
    for f in faults:
        f.validate()
    return ChaosPlan(seed=seed, faults=faults)


def _random_disagg_plan(seed: int, prefill_n: int, decode_n: int,
                        steps: int) -> ChaosPlan:
    """The ``profile="disagg"`` leg of :func:`random_plan`: the
    disaggregated-serving acceptance scenario (serve/disagg.py,
    docs/serving.md). Replica ids are fleet-wide — prefill replicas
    are ``0..prefill_n-1``, decode replicas ``prefill_n..`` (the
    DisaggRouter's ``rid_base`` convention) — so ``peer`` addressing
    stays unambiguous across the two pools. Composition:

    * one PREFILL worker SIGKILLed mid-traffic (``serve.proc`` crash,
      epoch-pinned to incarnation 0): in-flight requests it owned —
      including sequences parked awaiting migration — must re-prefill
      on a sibling exactly once while the pool respawns the victim;
    * a hard ``conn_reset`` on the KV-migration push to one decode
      replica (``serve.migrate``): the kv_install frame LANDED, the
      ack is lost — the retry ladder's replay must be served the
      decode endpoint's deduped install ack, never a double install;
    * a ``corrupt`` on a later migration: one payload bit flipped
      BEFORE framing, so only the per-block crc ledger travelling in
      the header can catch it — the push fails structurally and the
      router re-packs/re-prefills, never serving garbage KV.
    """
    if prefill_n < 2:
        raise PlanError(
            f"a disagg plan needs >= 2 prefill replicas (killing the "
            f"only one leaves nothing to re-prefill on); got "
            f"{prefill_n}")
    if decode_n < 1:
        raise PlanError(
            f"a disagg plan needs >= 1 decode replica; got {decode_n}")
    if steps < 40:
        raise PlanError(
            f"a disagg plan needs an iteration horizon >= 40; got "
            f"{steps}")
    rng = random.Random(seed)
    victim = rng.randrange(prefill_n)
    decode_rids = list(range(prefill_n, prefill_n + decode_n))
    faults = [
        # SIGKILL one PREFILL worker mid-traffic (epoch 0: a respawn's
        # fresh iteration counter re-crosses the address — same pin as
        # the fleet profile). The accrual sweep must eject within
        # 2x suspect_s, in-flight prefills/parked migrations must
        # re-prefill on the surviving sibling exactly once, and the
        # pool respawns the victim gated on the newest weights.
        Fault(rank=0, site="serve.proc", kind="crash", peer=victim,
              at=rng.randrange(steps // 4, steps // 2), epoch=0),
        # sever the migration socket after the kv_install frame lands:
        # the decode side installed, the ack is lost — the ladder
        # replay must hit the install dedupe (epoch 0: migration
        # counters reset on respawn too)
        Fault(rank=0, site="serve.migrate", kind="conn_reset",
              peer=rng.choice(decode_rids), at=rng.randrange(1, 4),
              epoch=0),
        # flip one payload bit pre-framing on later migrations: the
        # frame crc passes, the per-BLOCK crc ledger must catch it on
        # arrival before any token is generated from the blocks. A
        # WINDOW rather than an exact address: migration attempts are
        # counted per crossing, and a crossing can be a ladder REPLAY
        # of an already-installed fid — whose dedupe ack rightly
        # short-circuits before any payload look. Three crossings make
        # a fresh-push hit certain under real traffic.
        Fault(rank=0, site="serve.migrate", kind="corrupt",
              peer=rng.choice(decode_rids),
              after=(a := rng.randrange(5, 9)), until=a + 2,
              epoch=0),
    ]
    for f in faults:
        f.validate()
    return ChaosPlan(seed=seed, faults=faults)


def _random_autoscale_plan(seed: int, events: int) -> ChaosPlan:
    """The ``profile="autoscale"`` leg of :func:`random_plan`: the
    three disruptions a scale event must survive (docs/autoscale.md),
    addressed in SCALE-EVENT counters — the actuator passes its own
    applied-event ordinal to ``fire("autoscale.scale", step=n)``, so
    a fault at event 0 lands on the very first scale-up regardless of
    wall time. All faults fire on plan rank 0 (the router/actuator
    process). Composition:

    * ``crash`` on an early event: the newcomer worker is SIGKILLed
      mid-warmup, BEFORE admission — the actuator must retry the spawn
      and the front door must never 503 (pending capacity counts);
    * a ``delay`` window: the actuator stalls between spawn and the
      weight-stream admission gate, so a fresh version can be published
      underneath it — the gate must still admit only the newest;
    * a ``drop`` window on later events: a graceful scale-down drain is
      dropped (hard kill instead) — the parked-row/eject machinery must
      still answer every in-flight sequence exactly once.
    """
    if events < 6:
        raise PlanError(
            f"an autoscale plan needs a scale-event horizon >= 6 so "
            f"the drop window lands on a scale-down; got {events}")
    rng = random.Random(seed)
    a = rng.randrange(1, 3)
    b = rng.randrange(events // 2, events - 1)
    faults = [
        # SIGKILL the newcomer of the first scale-up (event 0): it was
        # never admitted, so no live traffic is touched — the actuator
        # must observe the death, re-spawn, and only then admit
        Fault(rank=0, site="autoscale.scale", kind="crash", at=0),
        # stall the actuator past the admission gate on an early event
        Fault(rank=0, site="autoscale.scale", kind="delay",
              seconds=round(rng.uniform(0.5, 1.5), 3),
              after=a, until=a + 2),
        # drop the drain of a later (scale-down) event: hard kill —
        # fires on every crossing in the window so it is certain to
        # land on at least one scale-down under a peak-then-cool load
        Fault(rank=0, site="autoscale.scale", kind="drop",
              after=b, until=events),
    ]
    for f in faults:
        f.validate()
    return ChaosPlan(seed=seed, faults=faults)


def _random_kvtier_plan(seed: int, replicas: int,
                        steps: int) -> ChaosPlan:
    """The ``profile="kvtier"`` leg of :func:`random_plan`: the four
    disruptions a tier move must survive (docs/serving.md failure
    matrix), addressed in per-replica TIER-OP counters — each replica's
    :class:`~horovod_tpu_torch.serve.kvtier.tier.ReplicaKVTier` passes its
    own demote/promote ordinal to ``fire(..., step=n)``, so addressing
    is deterministic per replica regardless of fleet interleaving. All
    faults fire on plan rank 0 (the serving process) and address
    replicas via ``peer``. Composition:

    * ``corrupt`` on one replica's early demotion: the bit flips AFTER
      the crc ledger is stamped over the clean bytes, so ONLY the
      promote-side per-leaf crc gate can catch it — before any device
      byte lands, falling back to re-prefill;
    * ``corrupt`` on another replica's early promotion: same gate,
      corrupting the bytes about to be verified;
    * ``drop`` on a demotion (the run dies — re-prefill on next use)
      and on a promotion (the promotion is lost — same fallback),
      both on later ops so clean moves happen first.
    """
    if replicas < 2:
        raise PlanError(
            f"a kvtier plan needs >= 2 replicas (the fleet index has "
            f"nothing to route across with one); got {replicas}")
    if steps < 8:
        raise PlanError(
            f"a kvtier plan needs a tier-op horizon >= 8 so drops "
            f"land after clean moves; got {steps}")
    rng = random.Random(seed)
    r_dc = rng.randrange(replicas)               # demote-corrupt victim
    r_pc = rng.randrange(replicas)               # promote-corrupt victim
    d_at = rng.randrange(1, 3)
    p_at = rng.randrange(1, 3)
    drop_d = rng.randrange(steps // 2, steps)
    drop_p = rng.randrange(steps // 2, steps)
    faults = [
        Fault(rank=0, site="kvtier.demote", kind="corrupt",
              peer=r_dc, at=d_at),
        Fault(rank=0, site="kvtier.promote", kind="corrupt",
              peer=r_pc, at=p_at),
        Fault(rank=0, site="kvtier.demote", kind="drop",
              peer=rng.randrange(replicas), at=drop_d),
        Fault(rank=0, site="kvtier.promote", kind="drop",
              peer=rng.randrange(replicas), at=drop_p),
    ]
    for f in faults:
        f.validate()
    return ChaosPlan(seed=seed, faults=faults)


def _random_serve_plan(seed: int, replicas: int, steps: int,
                       processes: bool = False) -> ChaosPlan:
    """The ``profile="serve"`` leg of :func:`random_plan`: the four
    disruptions the serving SLO soak must survive (replica killed
    mid-decode, router partition, KV corruption, slow host) plus one
    admission drop, every address derived from ``random.Random(seed)``
    alone. ``processes=True`` swaps in the multi-process composition
    (worker SIGKILL + dispatch-channel blips, see :func:`random_plan`)."""
    if replicas < 2:
        raise PlanError(
            f"a serve plan needs >= 2 replicas (a fleet of one has "
            f"nothing to fail over to); got {replicas}")
    if steps < 40:
        raise PlanError(
            f"a serve plan needs an iteration horizon >= 40 so the "
            f"crash lands before the corrupt; got {steps}")
    rng = random.Random(seed)
    if processes:
        victim = rng.randrange(replicas)
        others = [r for r in range(replicas) if r != victim]
        blipped = rng.choice(others)
        flaked = rng.choice(others)
        a = rng.randrange(20, 40)
        faults = [
            # SIGKILL one replica's worker PROCESS mid-traffic: its
            # heartbeat key goes stale, the router's accrual sweep must
            # eject within 2x suspect_s, respawn a fresh process, and
            # re-admit it on the newest published weight version.
            # epoch=0 pins the kill to the worker's FIRST incarnation
            # (workers install the injector with epoch=generation): the
            # respawn's fresh iteration counter re-crosses the same
            # 'at' address, and without the pin the victim would
            # SIGKILL itself again every generation, forever
            Fault(rank=0, site="serve.proc", kind="crash", peer=victim,
                  at=rng.randrange(steps // 4, steps // 2), epoch=0),
            # hard reset on a SURVIVOR's dispatch channel: the request
            # was sent, the reply socket is severed — the retry ladder
            # must re-dial and be served the deduped result, with ZERO
            # failovers and zero duplicate deliveries
            Fault(rank=0, site="serve.dispatch", kind="conn_reset",
                  peer=blipped, at=rng.randrange(4, 14)),
            # seeded flaky window on another survivor's channel:
            # per-dispatch drops the ladder absorbs in milliseconds.
            # The window is kept NARROWER than the ladder's depth
            # (default 4 retries) so even a worst-case all-drops window
            # still resolves within one request's ladder — blips must
            # never be able to exhaust into a failover by construction
            Fault(rank=0, site="serve.dispatch", kind="flaky",
                  peer=flaked, prob=round(rng.uniform(0.4, 0.6), 2),
                  after=a, until=a + rng.randrange(2, 4)),
            # one admission drop at a worker's queue door, absorbed by
            # router re-dispatch (never the client's problem); pinned
            # to incarnation 0 like the kill (a respawn resets the
            # submit counter too)
            Fault(rank=0, site="serve.admit", kind="drop",
                  peer=rng.randrange(replicas), at=rng.randrange(3, 10),
                  epoch=0),
        ]
        for f in faults:
            f.validate()
        return ChaosPlan(seed=seed, faults=faults)
    victim = rng.randrange(replicas)
    others = [r for r in range(replicas) if r != victim]
    partitioned = rng.choice(others)
    slow = rng.choice(others)
    corrupt = rng.choice(others)
    faults = [
        # kill one replica mid-decode: its batcher thread dies, its
        # heartbeats stop, the router must eject + re-enqueue
        Fault(rank=0, site="serve.step", kind="crash", peer=victim,
              at=rng.randrange(steps // 4, steps // 2)),
        # partition the router from a second replica: dispatches to it
        # are refused for the window; the router must route around it
        Fault(rank=0, site="serve.route", kind="partition",
              peer=partitioned, at=rng.randrange(4, 12),
              seconds=round(rng.uniform(1.5, 3.0), 3)),
        # corrupt a KV slot on a third: the per-slot crc must catch it
        # before any token of that sequence reaches a client
        Fault(rank=0, site="serve.kv", kind="corrupt", peer=corrupt,
              at=rng.randrange(steps // 2, (3 * steps) // 4)),
        # slow one host past the suspect threshold: ejected while
        # asleep, re-admitted when its heartbeats resume
        Fault(rank=0, site="serve.step", kind="slow_rank", peer=slow,
              at=rng.randrange((3 * steps) // 4, steps),
              seconds=round(rng.uniform(2.2, 2.8), 3)),
        # drop one admission: the router must absorb it (retry or
        # reject-with-retry-after), never lose the request silently
        Fault(rank=0, site="serve.admit", kind="drop",
              peer=rng.randrange(replicas), at=rng.randrange(3, 10)),
    ]
    for f in faults:
        f.validate()
    return ChaosPlan(seed=seed, faults=faults)
