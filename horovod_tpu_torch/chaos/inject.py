"""Zero-overhead-when-disabled fault-injection shims.

The port's copy of ``horovod_tpu/chaos/inject.py``: ``install``,
``install_from_env``, ``fire``, ``corrupt_copy`` and ``uninstall`` with
the reference's RNG use (``random.Random(f"{seed}:{rank}")``), so the
same plan flips the same bit in both packages. The port wires the
``serve.*`` and ``kvtier.*`` sites (serve/batcher.py, serve/queue.py,
serve/kvtier/tier.py); the wire, disk and step sites below belong to
planes the port has not taken yet. The timeline is not ported, so
:func:`_live_timeline` returns None and a fired fault emits no CHAOS
row, only its log line and ``hvd_chaos_faults_total``.

The reference's description of its sites follows.

One process-global :class:`Injector` (installed from
``HOROVOD_CHAOS_PLAN`` by ``hvd.init()``, or explicitly via
:func:`install`) is consulted by tiny guards at the REAL wire and disk
boundaries:

* ``native/store.py``   — every StoreClient request (set/get/gather/
  reduce): delay, drop (the request fails like a severed connection),
  corrupt (the outgoing payload bytes are bit-flipped), partition,
  crash; TRANSIENT kinds conn_reset/flaky (a retryable connection
  fault the native/resilience.py ladder absorbs by re-dialing and
  replaying) and jitter (seeded random request latency).
* ``native/p2p.py``     — ``RingComm._xfer`` (the single choke point
  every ring collective and ``shift`` passes through): delay, corrupt
  (tx payload), drop (the socket is REALLY closed, so the peer sees a
  genuine EOF at its end of the wire), partition, crash; TRANSIENT
  kinds conn_reset/flaky really close the live socket too, but the
  framed reconnect ladder re-rendezvouses over the KV and RESUMES the
  transfer instead of escalating; jitter sleeps.
* ``ckpt/store.py``     — shard file I/O: ``torn_write`` truncates the
  shard mid-file after the bytes were written (a torn write a restore
  must catch by CRC and recover via the buddy replica),
  ``delete_chunk`` removes a committed shard file, plus delay/crash on
  write/read/commit.
* ``redist.transport``  — every redistribution wire exchange and
  weight-stream chunk IO (redist/transport.py chaos_gate): delay,
  drop/partition (surface as RedistError -> the collective disk
  fallback), corrupt (one payload bit flipped — the per-frame crc32
  must catch it), crash.
* ``step``              — :func:`step_boundary`, called by the training
  loop (the soak worker does): crash (SIGKILL self — the host-loss
  scenario), slow_rank, delay.
* ``serve/``            — the serving fleet's real boundaries
  (serve/batcher.py, serve/queue.py, serve/fleet.py): ``serve.step``
  crash/slow a replica mid-decode (crash kills the replica's scheduler
  THREAD, not the process — the in-process replica-loss analog),
  ``serve.kv`` corrupt (one live sequence's device cache bytes
  bit-flipped — a slot row under the slotted layout, a BLOCK of the
  paged pool under the paged one; the crc-on-write option, per-slot
  or per-block respectively, must catch it before a client sees
  output), ``serve.route`` partition (the router's dispatches to one
  replica are refused for the window), ``serve.admit`` delay/drop at
  the queue door. Serve faults address replicas via ``peer``; guards
  pass the replica-local invocation counter explicitly.
* ``serve.proc`` / ``serve.dispatch`` — the MULTI-PROCESS fleet's
  boundaries (serve/proc_fleet.py, serve/worker.py): ``serve.proc``
  fires inside the replica WORKER PROCESS once per scheduler
  iteration, and ``crash`` there is interpreted by the worker's guard
  as a real ``os.kill(getpid(), SIGKILL)`` — safe precisely because
  that process IS the replica, unlike the in-process serve sites where
  a SIGKILL would take the router down too (fire() still returns
  serve.* crashes to the caller; the worker's guard pulls the
  trigger). ``serve.dispatch`` fires in the ROUTER process on its wire
  to one replica: ``conn_reset`` really severs the dispatch socket
  after the request frame was sent (the reply is lost — the retry
  ladder must re-dial and be served the replica's DEDUPED result),
  ``flaky`` drops the dispatch before it is sent, ``jitter``/``delay``
  sleep.

The guards read a single module attribute (``_INJ is not None``) when
disarmed, execute no other code, and never touch the payload — the
pass-through is byte-identical by construction (asserted by
tests/test_chaos.py). Everything here is stdlib-only at import time;
obs metrics and the timeline are reached lazily and only when a fault
actually fires.

Determinism: site invocation counters are per (site, rank) and advance
on every guarded call, so a fault addressed ``at: n`` lands on the same
wire/disk operation in every run of the same program; ``corrupt`` bit
positions derive from ``random.Random((plan.seed, rank))``.
"""
from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .plan import ChaosPlan, Fault

logger = logging.getLogger("horovod_tpu_torch")

#: the process-global injector; None = disarmed (every shim is a
#: byte-identical pass-through guarded by one attribute read)
_INJ: Optional["Injector"] = None


def _live_timeline():
    """The running timeline: None until ``timeline.py`` is ported (the
    reference's state plane, ROADMAP item A12), so a fired fault writes
    no CHAOS row."""
    return None


class Injector:
    """Evaluates a rank's slice of a :class:`ChaosPlan` at each site
    invocation. Thread-safe: the engine dispatch thread, the ckpt
    writer thread and the app thread may all cross sites concurrently.
    """

    def __init__(self, plan: ChaosPlan, rank: int, epoch: int = 0):
        self.plan = plan
        self.rank = int(rank)
        self.epoch = int(epoch)
        self._faults = plan.for_rank(self.rank)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._rng = random.Random(f"{plan.seed}:{self.rank}")
        # (site, peer) -> monotonic deadline while a partition is active
        self._partitions: Dict[Tuple[str, Optional[int]], float] = {}
        self._listeners: List[Callable[[dict], None]] = []
        self.fired: List[dict] = []

    # -- wiring ------------------------------------------------------------
    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """``fn(event_dict)`` on every fired fault (the soak worker's
        event log hook). Called before a crash takes the process down."""
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, fault: Fault, n: int, peer: Optional[int]) -> dict:
        ev = {"rank": self.rank, "site": fault.site, "kind": fault.kind,
              "n": n, "peer": peer, "epoch": self.epoch,
              "t": time.time()}
        with self._lock:
            self.fired.append(ev)
            listeners = list(self._listeners)
        logger.warning("CHAOS: injected %s at %s[%d] (rank %d%s)",
                       fault.kind, fault.site, n, self.rank,
                       f", peer {peer}" if peer is not None else "")
        for fn in listeners:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001 — a listener must not mask
                pass           # the fault it observes
        try:  # CHAOS timeline row + fault counter, both best-effort
            from ..obs import metrics as obs_metrics
            obs_metrics.get_registry().counter(
                "hvd_chaos_faults_total", "faults fired by the injector",
                {"kind": fault.kind, "site": fault.site}).inc()
        except Exception:  # noqa: BLE001
            pass
        tl = _live_timeline()
        if tl is not None:
            try:
                tl.instant("CHAOS", {k: v for k, v in ev.items()
                                     if k != "t"})
            except Exception:  # noqa: BLE001
                pass
        return ev

    # -- the hot path ------------------------------------------------------
    def fire(self, site: str, peer: Optional[int] = None,
             step: Optional[int] = None) -> Optional[Fault]:
        """Advance ``site``'s invocation counter and evaluate the plan.

        Sleeps here for ``delay``/``slow_rank``; SIGKILLs the process
        for ``crash``; registers ``partition`` windows. Returns the
        first matched fault the CALLER must interpret (drop / corrupt /
        partition / torn_write / delete_chunk) or None.
        """
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            if step is not None:
                n = int(step)
            now = time.monotonic()
            for (psite, ppeer), deadline in list(self._partitions.items()):
                if now >= deadline:
                    del self._partitions[(psite, ppeer)]
            part = self._partitions.get((site, peer)) \
                or self._partitions.get((site, None))
        # Scheduled faults evaluate FIRST: the invocation counter
        # advanced above regardless, so an active partition window must
        # not swallow an exact-'at' fault (a crash scheduled inside the
        # window would otherwise be consumed unseen and never fire —
        # and a soak would 'prove' recovery from a crash that never
        # happened).
        returned: Optional[Fault] = None
        for f in self._faults:
            if f.site != site or not f.matches(n, self.epoch):
                continue
            if f.peer is not None and peer is not None and f.peer != peer:
                continue
            if f.kind == "flaky":
                # seeded per-crossing draw: most crossings of the
                # window pass clean; a hit is returned like conn_reset
                # (the caller severs and the retry ladder heals)
                with self._lock:
                    draw = self._rng.random()
                if draw >= f.prob:
                    continue
            self._notify(f, n, peer)
            if f.kind in ("delay", "slow_rank"):
                time.sleep(f.seconds)
            elif f.kind == "jitter":
                # seeded random latency in (0, seconds] — pure delay,
                # nothing returned to the caller
                with self._lock:
                    d = self._rng.uniform(0.0, f.seconds)
                time.sleep(d)
            elif f.kind == "crash":
                if site.startswith("serve.") \
                        or site.startswith("autoscale."):
                    # a serve-plane crash kills the REPLICA, not the
                    # process: the caller (the batcher's step guard)
                    # raises and its scheduler thread dies — the
                    # in-process analog of a replica host loss, which
                    # is what stops its heartbeats and triggers the
                    # router's ejection path. SIGKILLing here would
                    # take the router and the healthy replicas down
                    # with the victim. An autoscale.scale crash is
                    # likewise RETURNED: the actuator is the guard —
                    # it SIGKILLs the newcomer worker it just spawned,
                    # never the router process.
                    returned = returned or f
                else:
                    # the host-loss scenario: no cleanup, no atexit, no
                    # flushes — exactly what a dead machine looks like
                    os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "partition":
                with self._lock:
                    self._partitions[(site, f.peer)] = \
                        time.monotonic() + f.seconds
                if f.peer is None or f.peer == peer:
                    returned = returned or f
            elif returned is None:
                returned = f
        if returned is None and part is not None:
            # inside an active window with nothing else scheduled: the
            # peer stays refused
            f = Fault(rank=self.rank, site=site, kind="partition",
                      peer=peer, seconds=1.0)
            self._notify(f, n, peer)
            return f
        return returned

    def corrupt_copy(self, payload) -> bytes:
        """A copy of ``payload`` with one deterministically chosen bit
        flipped — the smallest corruption a CRC/consistency check must
        still catch. Never mutates the input."""
        raw = bytearray(bytes(payload))
        if not raw:
            return bytes(raw)
        with self._lock:
            pos = self._rng.randrange(len(raw) * 8)
        raw[pos // 8] ^= 1 << (pos % 8)
        return bytes(raw)


# -- module-level API (what the shims and apps call) ------------------------

def armed() -> bool:
    """True when a plan is installed. The shims inline the equivalent
    ``_INJ is not None`` check so the disarmed cost is one attribute
    read."""
    return _INJ is not None


def injector() -> Optional[Injector]:
    return _INJ


def install(plan: ChaosPlan, rank: Optional[int] = None,
            epoch: Optional[int] = None) -> Injector:
    """Arm the process with ``plan``. Idempotent for an identical plan:
    re-installing (an in-process elastic reset re-runs ``hvd.init``)
    keeps the live injector so site counters and once-fired faults are
    not replayed."""
    global _INJ
    from . import process_identity
    if rank is None:
        rank = process_identity()[0]
    if epoch is None:
        epoch = int(os.environ.get("HOROVOD_CKPT_RESET_EPOCH", "0"))
    if _INJ is not None and _INJ.plan.to_json() == plan.to_json() \
            and _INJ.rank == int(rank) and _INJ.epoch == int(epoch):
        return _INJ
    _INJ = Injector(plan, rank=int(rank), epoch=int(epoch))
    logger.info("CHAOS: armed with %d fault(s) for rank %d (epoch %d, "
                "seed %d)", len(_INJ._faults), _INJ.rank, _INJ.epoch,
                plan.seed)
    return _INJ


def install_from_env() -> Optional[Injector]:
    """Arm from HOROVOD_CHAOS_PLAN; no-op (and disarm-preserving: an
    unset env never uninstalls an explicit plan) when unset."""
    plan = ChaosPlan.from_env()
    if plan is None:
        return _INJ
    return install(plan)


def uninstall() -> None:
    global _INJ
    _INJ = None


def fire(site: str, peer: Optional[int] = None,
         step: Optional[int] = None) -> Optional[Fault]:
    inj = _INJ
    if inj is None:
        return None
    return inj.fire(site, peer=peer, step=step)


def corrupt_copy(payload) -> bytes:
    inj = _INJ
    if inj is None:
        return bytes(payload)
    return inj.corrupt_copy(payload)


def step_boundary(step: int) -> None:
    """Training loops call this once per step so ``site: "step"``
    faults (crash, slow_rank, delay) land at a deterministic step
    number. No-op (one attribute read) when disarmed."""
    inj = _INJ
    if inj is not None:
        inj.fire("step", step=int(step))
