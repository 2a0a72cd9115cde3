"""Replica worker process: one OS process, one serving replica.

The port of ``horovod_tpu/serve/worker.py``, the unit the process fleet
(``serve/proc_fleet.py``) is made of. Each worker hosts a whole serving
stack — ``ShardedExecutor`` (K1 through captured CUDA graphs on a card),
``AdmissionQueue``, ``ContinuousBatcher`` with the paged KV, the prefix
cache, the crc ledger and the KV tier — in a CUDA context of its own,
plus what makes it a fleet citizen across a process boundary:

* **A request endpoint** (:class:`ReplicaEndpoint`): a threading TCP
  server speaking ``serve/wire.py``'s framed protocol. Every ``submit``
  carries a router-made request id (``fid``); a bounded resolution cache
  and an in-flight table keyed by it serve a REPLAYED dispatch (the
  router's retry ladder re-dialing after a ``conn_reset`` ate the reply)
  its cached or still-cooking result, never a second execution.
* **Heartbeats over the native KV store**: ``serve.hb.<ns>.g<gen>.<rid>``
  = ``<seq>:<wall>``, posted by a chaos-exempt ``StoreClient`` on its own
  thread; the sequence advances only when the scheduler iterates, so a
  wedged scheduler goes stale at the router's accrual sweep while the
  poster lives. The registration key ``serve.ep.<ns>.g<gen>.<rid>``
  (endpoint, pid, weight version, start-up timings) is the ready signal.
* **The weight gate**: a config naming a ``channel`` (with the store's
  address) gets a ``redist.stream.WeightSubscriber`` templated on the
  serving model. Start-up blocks until the channel's newest published
  version is adopted (``_weight_gate``); the batcher then polls the
  subscriber between iterations and hot-swaps newer versions.

Chaos: the worker installs the fleet's plan (epoch = its generation) and
fires ``serve.proc`` once per scheduler iteration; ``crash`` there is a
real ``SIGKILL`` of the process. The disaggregated-serving ops
(``serve/disagg.py``): ``migrate`` packs a parked row and pushes it to
the decode endpoint the router names, ``release`` frees a parked row,
``result`` waits out a migrated request, and ``kv_install`` receives a
migrated row (crc-verified, fid-deduped against the ladder's replays).

The config travels as inline JSON in ``HOROVOD_SERVE_WORKER_CFG``. Its
``"device"`` key: absent or ``"cuda"`` serves on the card; only
``"cpu"`` runs the plain versions. A worker that finds no CUDA device
without ``"cpu"`` exits non-zero naming the device; one whose K1 fails
to load or launch dies at warm-up, before it registers.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import socketserver
import sys
import threading
import time
from collections import OrderedDict
from types import SimpleNamespace
from typing import Any, Dict, Optional

from ..trace.spans import configure_recorder as _trace_configure
from ..trace.spans import get_recorder as _trace_recorder
from . import wire
from .queue import AdmitDropped, Rejected

logger = logging.getLogger("horovod_tpu_torch")

#: resolved results retained for replay dedupe (the store.cc DoneRound
#: TTL cache analog, bounded by count instead of time)
DEDUPE_CAP = 4096

#: extra wait past a request's own deadline before the endpoint calls
#: it stalled — the batcher resolves expiry itself within one
#: iteration, so this only fires when the scheduler is wedged
REPLY_GRACE_S = 30.0


def _load_flax_npz(path: str) -> dict:
    """A flax parameter tree saved flat in an ``.npz`` (keys are the
    tree's paths joined by ``/``) back as nested dicts."""
    import numpy as np
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def tiny_gpt_builder(seed: int = 0, paged: bool = True,
                     vocab_size: int = 64, num_layers: int = 2,
                     num_heads: int = 2, head_dim: int = 8,
                     max_seq_len: int = 48, max_batch: int = 4,
                     kv_block_size: int = 4, kv_pool_blocks: int = 32,
                     draft: bool = False, params_npz: Optional[str] = None,
                     device=None) -> Dict[str, Any]:
    """The reference's built-in tiny decode GPT (fp32). Its weights:
    ``params_npz`` (a flattened flax tree, e.g. the reference's own
    params, carried across by ``models/convert.py gpt_from_flax``), else
    drawn by ``init_gpt_params`` from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` — DETERMINISTIC per seed and device type, so
    every worker process of a fleet and the soak's publisher derive the
    same bits without shipping arrays over the spawn boundary (the
    reference derives them with ``jax.random``, which the port does not
    have). ``params`` is the state dict the models were loaded with."""
    import torch

    from .._device import resolve_device
    from ..models.convert import gpt_from_flax, init_gpt_params
    from ..models.gpt import GPT, GPTConfig
    kw = dict(vocab_size=vocab_size, num_layers=num_layers,
              num_heads=num_heads, head_dim=head_dim,
              max_seq_len=max_seq_len, dtype=torch.float32)
    paged_kw = dict(kv_block_size=kv_block_size,
                    kv_pool_blocks=kv_pool_blocks) if paged else {}
    cfg = GPTConfig(decode=True, **kw, **paged_kw)
    if params_npz is not None:
        sd = gpt_from_flax(_load_flax_npz(params_npz))
    else:
        dev = resolve_device(device)
        sd = init_gpt_params(
            cfg, torch.Generator(device=dev).manual_seed(int(seed)), dev)
    model = GPT(cfg, device=device)
    model.load_state_dict(sd)
    draft_model = None
    if draft:
        draft_model = GPT(GPTConfig(decode=True, **kw), device=device)
        draft_model.load_state_dict(sd)
    return {"model": model, "params": sd, "draft_model": draft_model,
            "eos_id": None, "max_batch": max_batch, "max_len": max_seq_len}


def llama_builder(preset: str = "Llama_1B", seed: int = 0,
                  dtype: str = "bfloat16", max_batch: int = 8,
                  max_len: int = 2048, kv_block_size: int = 16,
                  kv_pool_blocks: Optional[int] = None,
                  buckets=(128, 512), device=None,
                  **overrides) -> Dict[str, Any]:
    """A paged Llama decode model at a preset's widths (``overrides``
    replace preset fields: ``num_layers`` and friends), its weights drawn
    on ``device`` by ``init_llama_params`` from ``seed`` — the way
    ``chip_smoke.py`` phase 3 draws them, so every worker of a fleet and
    the smoke test hold the same bits."""
    import torch

    from ..models import llama as llama_mod
    from ..models.convert import init_llama_params
    from .kv_cache import pool_blocks_for
    if not hasattr(llama_mod, preset):
        raise ValueError(f"unknown Llama preset {preset!r}")
    make = getattr(llama_mod, preset)
    dt = getattr(torch, dtype)
    dev = torch.device("cuda" if device is None else device)
    sd = init_llama_params(
        make(dtype=dt, **overrides),
        torch.Generator(device=dev).manual_seed(int(seed)), dev)
    blocks = kv_pool_blocks or pool_blocks_for(max_batch, max_len,
                                               kv_block_size)
    model = llama_mod.Llama(make(dtype=dt, kv_block_size=kv_block_size,
                                 kv_pool_blocks=blocks, **overrides),
                            device=dev)
    model.load_state_dict(sd)
    del sd
    return {"model": model, "draft_model": None, "eos_id": None,
            "max_batch": max_batch, "max_len": max_len,
            "buckets": tuple(buckets)}


def _resolve_builder(spec: str):
    """'module:function' -> callable, fail-fast."""
    import importlib
    mod, _, fn = spec.partition(":")
    if not mod or not fn:
        raise ValueError(
            f"worker builder must be 'module:function'; got {spec!r}")
    return getattr(importlib.import_module(mod), fn)


def build_replica_stack(cfg: dict, rid: int = 0, device=None,
                        timings: Optional[dict] = None):
    """The serving stack a worker config describes: the builder's model
    on ``device`` behind ``ShardedExecutor`` (and a drafter when the
    builder gives one), an ``AdmissionQueue`` and a
    ``ContinuousBatcher`` with the config's crc ledger, prefix cache and
    KV tier. Not warmed up. ``timings`` gets ``weights_s``. Returns a
    namespace (``built``, ``executor``, ``draft_executor``, ``queue``,
    ``batcher``)."""
    from .batcher import ContinuousBatcher
    from .executor import ShardedExecutor
    from .queue import AdmissionQueue
    t0 = time.perf_counter()
    built = _resolve_builder(
        cfg.get("builder",
                "horovod_tpu_torch.serve.worker:tiny_gpt_builder"))(
        **(cfg.get("builder_kwargs") or {}), device=device)
    max_batch = int(built.get("max_batch", 4))
    max_len = int(built.get("max_len", 48))
    executor = ShardedExecutor(built["model"], max_batch=max_batch,
                               max_len=max_len, device=device,
                               replica_id=rid)
    draft = built.get("draft_model")
    draft_executor = None if draft is None else ShardedExecutor(
        draft, max_batch=max_batch, max_len=max_len, device=device,
        replica_id=rid, role="draft")
    if timings is not None:
        timings["weights_s"] = time.perf_counter() - t0
    queue = AdmissionQueue(
        max_queue=int(cfg.get("max_queue", 64)),
        default_deadline_ms=float(cfg.get("deadline_ms", 30000.0)),
        replica_id=rid)
    batcher = ContinuousBatcher(
        executor, queue,
        buckets=tuple(cfg.get("buckets") or built.get("buckets") or (8,)),
        eos_id=built.get("eos_id"), replica_id=rid,
        kv_crc=cfg.get("kv_crc"), draft_executor=draft_executor,
        spec_k=cfg.get("spec_k"), prefix_cache=cfg.get("prefix_cache"),
        kv_tier=cfg.get("kv_tier"),
        kvtier_host_mb=cfg.get("kvtier_host_mb"),
        # a shared spill root is partitioned per replica: two workers
        # scanning one directory would double-count runs
        kvtier_dir=(os.path.join(str(cfg["kvtier_dir"]), f"r{rid}")
                    if cfg.get("kvtier_dir") else None))
    return SimpleNamespace(built=built, executor=executor,
                           draft_executor=draft_executor, queue=queue,
                           batcher=batcher)


class ReplicaEndpoint:
    """The worker's request endpoint: framed submit / healthz / metrics
    over TCP with fid-keyed replay dedupe. Usable in-thread (the tests
    run it against a local batcher without any subprocess)."""

    def __init__(self, batcher, *, rid: int,
                 host: str = "127.0.0.1", port: int = 0,
                 dedupe_cap: int = DEDUPE_CAP):
        self.batcher = batcher
        self.rid = int(rid)
        self._lock = threading.Lock()
        self._inflight: Dict[str, Any] = {}
        self._done: "OrderedDict[str, dict]" = OrderedDict()
        self._dedupe_cap = int(dedupe_cap)
        #: replayed dispatches served from the cache or the in-flight
        #: table instead of being executed twice
        self.dedupe_hits = 0
        self.submits = 0
        #: in-progress kv_install entries keyed by fid: a replayed
        #: install arriving while the original is still installing joins
        #: its outcome instead of installing twice
        self._installing: Dict[str, dict] = {}
        #: extra healthz facts (the worker's start-up timings)
        self.extra_health: Dict[str, Any] = {}
        #: the worker's weight subscriber: its newest adoption's timings
        #: ride the healthz reply
        self.subscriber = None
        #: ``plan_dict -> None``: arms a chaos plan (the ``chaos`` op);
        #: None (an endpoint without a worker) answers it unknown
        self.on_chaos = None
        ep = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    msg, payload = wire.recv_any(self.request,
                                                 timeout=30.0)
                    ep._handle(self.request, msg, payload)
                except (wire.DispatchConnError, wire.DispatchError,
                        OSError):
                    # resilience: exempt (the client vanished or spoke
                    # garbage — the retry ladder lives ROUTER-side; any
                    # computed result is already in the dedupe cache
                    # for the replay)
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"hvd-replica-ep-{rid}")

    def start(self) -> "ReplicaEndpoint":
        self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # -- request handling ---------------------------------------------------
    def _handle(self, sock, msg: dict,
                payload: Optional[bytes] = None) -> None:
        op = msg.get("op")
        if op == "healthz":
            info = self.healthz()
            if msg.get("step_ms"):
                # opt-in: the executor's recent step host ms by kind
                info["step_ms"] = {
                    k: list(v) for k, v in
                    self.batcher.executor.step_latencies_ms.items()}
            wire.send_msg(sock, info)
            return
        if op == "metrics":
            # the fleet /metrics?fleet=1 scrape leg: the worker's whole
            # registry snapshot rides one JSON reply (serve/http.py
            # merges it with its siblings')
            from ..obs import metrics as obs_metrics
            wire.send_msg(sock, {
                "ack": "metrics",
                "snapshot": obs_metrics.get_registry().snapshot()})
            return
        if op == "chaos" and self.on_chaos is not None:
            # arm a chaos plan in this process now (the worker's own
            # injector, epoch = its generation): how a supervisor lands
            # a fault at a known iteration of a live worker
            try:
                if not isinstance(msg.get("plan"), dict):
                    raise ValueError("chaos requires a plan")
                self.on_chaos(msg["plan"])
            except (KeyError, ValueError, TypeError) as e:
                wire.send_msg(sock, {"ack": "bad_request",
                                     "error": str(e)})
                return
            wire.send_msg(sock, {"ack": "armed",
                                 "iterations": self.batcher.iterations})
            return
        if op == "kv_install":
            self._handle_kv_install(sock, msg, payload or b"")
            return
        if op in ("migrate", "release", "result"):
            self._handle_disagg(sock, op, msg)
            return
        if op != "submit":
            wire.send_msg(sock, {"ack": "bad_request",
                                 "error": f"unknown op {op!r}"})
            return
        if msg.get("fid") in (None, ""):
            # a missing fid must not collapse onto one shared dedupe
            # key (str(None) == "None" would serve one caller another
            # request's cached tokens)
            wire.send_msg(sock, {"ack": "bad_request",
                                 "error": "submit requires a fid"})
            return
        fid = str(msg["fid"])
        with self._lock:
            self.submits += 1
            self._sweep_orphans_locked()
            cached = self._done.get(fid)
            handle = None if cached is not None \
                else self._inflight.get(fid)
            if cached is not None or handle is not None:
                # the replay-dedupe core: a re-dispatched request whose
                # reply was lost is served its existing result (or
                # joins the in-flight wait) — never executed twice
                self.dedupe_hits += 1
            elif self.batcher.draining:
                wire.send_msg(sock, {"ack": "rejected",
                                     "reason": "replica draining",
                                     "retry_after_ms": 1000.0})
                return
            else:
                try:
                    handle = self.batcher.queue.submit(
                        msg["prompt"],
                        max_new_tokens=int(msg.get("max_new_tokens", 16)),
                        deadline_ms=msg.get("deadline_ms"),
                        temperature=float(msg.get("temperature", 0.0)),
                        top_p=float(msg.get("top_p", 1.0)),
                        seed=int(msg.get("seed", 0)),
                        hold_kv=bool(msg.get("hold_kv", False)),
                        trace=msg.get("trace"))
                except AdmitDropped as e:
                    wire.send_msg(sock, {
                        "ack": "admit_dropped",
                        "retry_after_ms": e.retry_after_ms})
                    return
                except Rejected as e:
                    wire.send_msg(sock, {
                        "ack": "rejected", "reason": e.reason,
                        "retry_after_ms": e.retry_after_ms})
                    return
                except (KeyError, ValueError, TypeError) as e:
                    wire.send_msg(sock, {"ack": "bad_request",
                                         "error": str(e)})
                    return
                self._inflight[fid] = handle
        # accepted (fresh or replayed): ack now, result when it lands
        wire.send_msg(sock, {"ack": "accepted"})
        deadline_ms = msg.get("deadline_ms") \
            or self.batcher.queue.default_deadline_ms
        self._await_and_reply(sock, fid, handle, cached, deadline_ms,
                              trace=msg.get("trace"))

    def _record(self, handle) -> dict:
        """The cached (replay-servable) rendering of a resolved handle.
        ``rid`` rides along so the ``migrate`` op can find the parked
        row a ``hold_kv`` prefill left behind."""
        return {"status": handle.status, "tokens": list(handle.tokens),
                "error": handle.error, "latency_ms": handle.latency_ms,
                "rid": handle.rid}

    def _sweep_orphans_locked(self) -> None:
        """Lazily migrate resolved orphans (a client that vanished
        before the ack leaves its entry here) into the bounded done
        cache, so the in-flight table cannot grow past the queue's own
        bounds. Caller holds ``self._lock``."""
        for k in [k for k, h in self._inflight.items() if h.done()]:
            h = self._inflight.pop(k)
            self._done[k] = self._record(h)
            while len(self._done) > self._dedupe_cap:
                self._done.popitem(last=False)

    def _await_and_reply(self, sock, fid: str, handle,
                         cached: Optional[dict],
                         deadline_ms: float,
                         trace: Optional[dict] = None) -> None:
        """Wait out the handle (unless a cached record already answers
        the replay), cache BEFORE sending — if the send dies with the
        reply, the replay finds the result here. A traced request's
        completed spans piggyback on the reply as ``spans`` (drained at
        send time, NOT cached: a replay re-reads the result, not the
        telemetry)."""
        if cached is None:
            handle.wait(timeout=float(deadline_ms) / 1000.0
                        + REPLY_GRACE_S)
            if handle.done():
                cached = self._record(handle)
            else:
                # scheduler wedged past deadline + grace: a structured
                # error, not a dropped socket (NOT cached — a replay
                # after the replica recovers may still resolve it)
                wire.send_msg(sock, {"status": "error",
                                     "error": "replica stalled",
                                     "tokens": [], "latency_ms": None})
                return
            with self._lock:
                self._done[fid] = cached
                self._inflight.pop(fid, None)
                while len(self._done) > self._dedupe_cap:
                    self._done.popitem(last=False)
        reply = cached
        if isinstance(trace, dict) and trace.get("trace"):
            spans = _trace_recorder().drain(str(trace["trace"]))
            if spans:
                reply = dict(cached, spans=spans)
        wire.send_msg(sock, reply)

    # -- disaggregated serving ops (serve/disagg.py) -------------------------
    def _handle_disagg(self, sock, op: str, msg: dict) -> None:
        """``migrate`` / ``release`` / ``result``: the prefill-pool and
        decode-pool halves of KV-block migration, addressed by the same
        fid namespace and dedupe discipline as ``submit``."""
        from . import kv_migrate
        fid = str(msg.get("fid") or "")
        if not fid:
            wire.send_msg(sock, {"ack": "bad_request",
                                 "error": f"{op} requires a fid"})
            return
        with self._lock:
            self._sweep_orphans_locked()
            cached = self._done.get(fid)
            handle = self._inflight.get(fid)
            if op == "result" and cached is not None:
                self.dedupe_hits += 1
        if op == "result":
            # the decode side's completion wait: a submit's reply leg
            # (ack, block, cached-replay dedupe)
            if cached is None and handle is None:
                wire.send_msg(sock, {"ack": "unknown_fid"})
                return
            wire.send_msg(sock, {"ack": "accepted"})
            deadline_ms = msg.get("deadline_ms") \
                or self.batcher.queue.default_deadline_ms
            self._await_and_reply(sock, fid, handle, cached, deadline_ms,
                                  trace=msg.get("trace"))
            return
        rid = cached.get("rid") if cached is not None else \
            (handle.rid if handle is not None else None)
        if rid is None:
            wire.send_msg(sock, {"ack": "migrate_failed",
                                 "reason": "unknown_fid"})
            return
        if op == "release":
            self.batcher.release_parked(int(rid))
            wire.send_msg(sock, {"ack": "released"})
            return
        # migrate: pack the parked row and push it to the decode endpoint
        # the router chose (serve.migrate chaos and the retry ladder live
        # inside kv_migrate.push)
        t0 = time.monotonic()
        try:
            packet = kv_migrate.pack_parked(
                self.batcher, int(rid), fid=str(msg["dfid"]),
                max_new_tokens=int(msg["max_new_tokens"]),
                deadline_ms=float(msg.get("deadline_ms") or 30000.0))
        except kv_migrate.MigrateCorrupt as e:
            # the source blocks are untrusted: free them, so the
            # re-prefill that follows runs on clean capacity
            self.batcher.release_parked(int(rid))
            wire.send_msg(sock, {"ack": "migrate_failed",
                                 "reason": "source_corrupt",
                                 "detail": str(e)[:200]})
            return
        except (KeyError, ValueError, TypeError) as e:
            wire.send_msg(sock, {"ack": "bad_request",
                                 "error": str(e)[:200]})
            return
        if packet is None:
            wire.send_msg(sock, {"ack": "migrate_failed",
                                 "reason": "not_parked"})
            return
        header, payload = packet
        try:
            target = (str(msg["target"][0]), int(msg["target"][1]))
            ack = kv_migrate.push(target, header, payload,
                                  peer=msg.get("peer"))
        except (wire.DispatchConnError, wire.DispatchError) as e:
            wire.send_msg(sock, {"ack": "migrate_failed",
                                 "reason": "unreachable",
                                 "detail": str(e)[:200]})
            return
        if ack.get("ack") == "installed":
            # the blocks live on the decode replica now: free the parked
            # row (the scheduler thread frees it)
            self.batcher.release_parked(int(rid))
            reply = {
                "ack": "migrated", "bytes": len(payload),
                "blocks": len(header["blocks"]),
                "ms": round((time.monotonic() - t0) * 1000.0, 3),
                "dedupe": bool(ack.get("dedupe", False))}
            tr = header.get("trace")
            if isinstance(tr, dict) and tr.get("trace"):
                base = time.time() - time.monotonic()
                _trace_recorder().record(
                    tr, "migrate_push", t0 + base, time.time(),
                    fid=str(msg.get("dfid")), bytes=len(payload))
                spans = _trace_recorder().drain(str(tr["trace"]))
                if spans:
                    reply["spans"] = spans
            wire.send_msg(sock, reply)
            return
        wire.send_msg(sock, {
            "ack": "migrate_failed",
            "reason": str(ack.get("ack", "unknown")),
            "detail": ack.get("detail") or ack.get("error"),
            "retry_after_ms": ack.get("retry_after_ms")})

    def _handle_kv_install(self, sock, msg: dict, payload: bytes) -> None:
        """Receive a migrated row (the decode-pool side): crc
        verification and the reservation-gated install ride
        ``kv_migrate``; the fid dedupe (done cache, in-flight table,
        installs in progress) makes a ladder replay of a severed push
        converge on one install and one ack."""
        from . import kv_migrate
        fid = str(msg.get("fid") or "")
        if not fid:
            wire.send_msg(sock, {"ack": "bad_request",
                                 "error": "kv_install requires a fid"})
            return
        mine = False
        with self._lock:
            self._sweep_orphans_locked()
            if fid in self._done or fid in self._inflight:
                self.dedupe_hits += 1
                ent = None
            else:
                ent = self._installing.get(fid)
                if ent is None:
                    mine = True
                    ent = {"evt": threading.Event(), "outcome": None,
                           "handle": None}
                    self._installing[fid] = ent
                else:
                    self.dedupe_hits += 1
        if ent is None:
            # already installed (or even resolved): the replay of a
            # severed push gets the same ack, never a second copy
            wire.send_msg(sock, {"ack": "installed", "dedupe": True})
            return
        if mine:
            t_i0 = time.time()
            try:
                blocks = kv_migrate.unpack_blocks(msg, payload)
            except kv_migrate.MigrateCorrupt as e:
                self.batcher.note_migrate_corrupt()
                self._finalize_install(fid, ent, ("corrupt", str(e)), None)
            else:
                pending = self.batcher.submit_migrated(msg, blocks)
                if pending["evt"].wait(kv_migrate.INSTALL_ACK_TIMEOUT_S):
                    out = pending["outcome"]
                    tr = msg.get("trace")
                    if isinstance(tr, dict) and tr.get("trace"):
                        # the decode side's receive span, drained with the
                        # result op's reply
                        _trace_recorder().record(
                            tr, "migrate_install", t_i0, time.time(),
                            fid=fid, outcome=str(out[0]))
                    self._finalize_install(
                        fid, ent, out,
                        pending["handle"] if out[0] == "installed"
                        else None)
                else:
                    # the scheduler has not picked the entry up yet: the
                    # install is pending, not dead. The _installing entry
                    # stays so a ladder replay joins this install, and a
                    # finisher thread completes the bookkeeping (the
                    # handle for the result op) whenever it lands
                    def finish():
                        pending["evt"].wait(REPLY_GRACE_S * 10)
                        out = pending["outcome"] or ("stalled", None)
                        self._finalize_install(
                            fid, ent, out,
                            pending["handle"] if out[0] == "installed"
                            else None)
                    threading.Thread(
                        target=finish, daemon=True,
                        name=f"hvd-install-finish-{self.rid}").start()
        else:
            ent["evt"].wait(kv_migrate.INSTALL_ACK_TIMEOUT_S + 5.0)
        outcome, detail = ent["outcome"] or ("stalled", None)
        if outcome == "installed":
            wire.send_msg(sock, {"ack": "installed", "dedupe": not mine})
        elif outcome == "corrupt":
            wire.send_msg(sock, {"ack": "migrate_corrupt",
                                 "detail": detail})
        elif outcome == "version_mismatch":
            wire.send_msg(sock, {"ack": "version_mismatch",
                                 "detail": detail})
        elif outcome == "rejected":
            wire.send_msg(sock, {"ack": "rejected",
                                 "retry_after_ms": detail})
        else:
            wire.send_msg(sock, {"ack": "bad_request",
                                 "error": f"{outcome}: {detail}"})

    def _finalize_install(self, fid: str, ent: dict, outcome: tuple,
                          handle) -> None:
        """Complete a kv_install's bookkeeping once: record the outcome,
        register the handle for the result op, drop the in-progress
        entry, wake every waiter (the original and any joined replay)."""
        with self._lock:
            ent["outcome"] = outcome
            ent["handle"] = handle
            if handle is not None:
                self._inflight[fid] = handle
            self._installing.pop(fid, None)
        ent["evt"].set()

    def healthz(self) -> dict:
        b = self.batcher
        ex = b.executor
        info = {"replica": self.rid,
                "replica_up": b.alive(),
                "draining": bool(getattr(b, "draining", False)),
                "load": b.load(),
                "iterations": b.iterations,
                "weights_version": ex.params_version,
                "swaps": ex.swaps,
                "last_swap": dict(ex.last_swap),
                "dedupe_hits": self.dedupe_hits,
                "kv_corruptions_injected": b.kv_corruptions_injected,
                "kv_corruptions_detected": b.kv_corruptions_detected,
                # the card's evidence that K1 runs in this process:
                # diagnostics only, the fleet routes on none of them
                "kernel": ex.kernel,
                "k1_launches": ex.k1_launches,
                "k1_launches_process": _k1_process_launches(),
                "replays": ex.replays,
                "steps": ex.steps,
                "steps_by_kind": dict(ex.steps_by_kind),
                "graphs": ex.jit_cache_size()}
        if getattr(b, "paged", False):
            info["kv_blocks_in_use"] = b.kv.pool.in_use()
            info["kv_blocks_total"] = b.kv.pool.num_blocks
            info["kv_block_size"] = b.kv.pool.block_size
            # blocks held ONLY by the prefix cache (refcount-zero
            # runs): resident but reclaimable on demand
            info["kv_blocks_evictable"] = (
                b.prefix.evictable_blocks()
                if getattr(b, "prefix", None) is not None else 0)
            if getattr(b, "prefix", None) is not None:
                info["prefix_tokens_resident"] = \
                    b.prefix.resident_tokens()
                info["prefix_tokens_evictable"] = \
                    b.prefix.evictable_tokens()
            if getattr(b, "kvtier", None) is not None:
                # the fleet index's event feed piggybacks the healthz
                # reply (the channel the router already polls)
                info["kvtier_events"] = b.kvtier.drain_events()
                info["kvtier"] = b.kvtier.stats()
        info["migrations_in"] = b.migrations_in
        info["migrate_rejects"] = b.migrate_rejects
        info["migrate_corrupt_detected"] = b.migrate_corrupt_detected
        with b._parked_lock:
            info["parked"] = len(b.parked)
        from ..native.resilience import RETRIES_HELP
        from ..obs import metrics as obs_metrics
        info["migrate_absorbed"] = int(obs_metrics.get_registry().counter(
            "hvd_net_retries_total", RETRIES_HELP,
            {"site": "serve.migrate", "outcome": "absorbed"}).value)
        if ex.device.type == "cuda":
            import torch
            info["cuda_mem"] = {
                "allocated_gb": torch.cuda.memory_allocated(ex.device) / 1e9,
                "reserved_gb": torch.cuda.memory_reserved(ex.device) / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated(ex.device) / 1e9}
        if self.subscriber is not None:
            info["stream"] = dict(self.subscriber.last,
                                  refused=self.subscriber.refused)
        info.update(b.queue.counters())
        info.update(self.extra_health)
        return info


def _k1_process_launches() -> int:
    from ..ops.paged import paged_attention_fused
    return int(paged_attention_fused.launches)


class ReplicaWorker:
    """The whole worker process, assembled from a config dict (see the
    module docstring). In-process usable for tests; :func:`main` wraps
    it for the real spawned process."""

    def __init__(self, cfg: dict):
        import torch

        from .._device import resolve_device
        self.cfg = dict(cfg)
        self.rid = int(cfg["rid"])
        self.gen = int(cfg.get("gen", 0))
        self.ns = str(cfg.get("ns", "fleet"))
        #: start-up phases in seconds (and ``t_main``, the wall clock
        #: when the worker began, after the interpreter and the imports)
        self.startup: Dict[str, float] = {
            "t_main": float(cfg.get("_t_main", time.time()))}
        self.device = resolve_device(cfg.get("device"))
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            torch.cuda.init()
            torch.empty(1, device=self.device)
            self.startup["cuda_s"] = time.perf_counter() - t0
        # stamp this process's span recorder with its fleet identity
        # (pool/replica/generation name the Chrome-trace pid row)
        _trace_configure(pool=str(cfg.get("pool") or self.ns),
                         replica=self.rid, gen=self.gen)
        self.hb_interval_s = float(cfg.get("hb_interval_s", 0.125))
        self._events_f = None
        events_path = cfg.get("events_path")
        if events_path:
            self._events_f = open(events_path, "a", buffering=1)
        self._install_chaos(cfg.get("chaos_plan"))

        stack = build_replica_stack(cfg, self.rid, self.device,
                                    self.startup)
        self.executor = stack.executor
        self.draft_executor = stack.draft_executor
        self.queue = stack.queue
        self.batcher = stack.batcher
        # scheduler-iteration pulse: advances the heartbeat seq AND
        # crosses the serve.proc chaos gate (crash there = SIGKILL of
        # THIS process — the real host loss)
        self.seq = 0
        self.batcher.heartbeat = self._pulse
        # chaos-exempt KV client: the observer plane (heartbeats +
        # endpoint registration) must be neither faulted nor allowed to
        # skew site counters
        self._kv = None
        kv_addr, kv_port = cfg.get("kv_addr"), cfg.get("kv_port")
        if kv_addr and kv_port:
            from ..native.store import StoreClient
            self._kv = StoreClient(str(kv_addr), int(kv_port),
                                   rank=self.rid, chaos_exempt=True)
        self.subscriber = None
        channel = cfg.get("channel")
        if channel and kv_addr and kv_port:
            from ..native.store import StoreClient
            from ..redist.stream import WeightSubscriber
            self.subscriber = WeightSubscriber(
                str(channel),
                client=StoreClient(str(kv_addr), int(kv_port),
                                   rank=self.rid, chaos_exempt=True),
                template=self.executor.model)
        self.endpoint = ReplicaEndpoint(
            self.batcher, rid=self.rid,
            host=str(cfg.get("host", "127.0.0.1")))
        self.endpoint.on_chaos = self._install_chaos
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.draining = False
        self._drained = threading.Event()

    # -- chaos wiring --------------------------------------------------------
    def _install_chaos(self, plan_obj) -> None:
        """Arm ``plan_obj`` (a ``ChaosPlan`` or its dict) in this process,
        replacing any plan; the events ledger, when configured, hears
        every fired fault."""
        if not plan_obj:
            return
        from ..chaos import inject
        from ..chaos.plan import ChaosPlan
        plan = plan_obj if isinstance(plan_obj, ChaosPlan) \
            else ChaosPlan.from_dict(plan_obj)
        # epoch = the worker's GENERATION: a respawned worker's fresh
        # iteration/submit counters re-cross every exact-'at' address,
        # so epoch-pinned faults fire in exactly one incarnation
        inj = inject.install(plan, rank=0, epoch=self.gen)
        if self._events_f is not None:
            f = self._events_f

            def log_event(ev: dict) -> None:
                f.write(json.dumps(ev, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())

            inj.add_listener(log_event)

    def _pulse(self) -> None:
        self.seq += 1
        from ..chaos import inject as _chaos
        if _chaos._INJ is None:
            return
        f = _chaos.fire("serve.proc", peer=self.rid,
                        step=self.batcher.iterations)
        if f is not None and f.kind == "crash":
            # the REAL host loss: no cleanup, no flushes beyond the
            # listener ledger (already fsync'd), no goodbye on the
            # heartbeat key — what a dead machine looks like to the
            # router's accrual sweep
            os.kill(os.getpid(), signal.SIGKILL)

    # -- lifecycle -----------------------------------------------------------
    def hb_key(self) -> str:
        return f"serve.hb.{self.ns}.g{self.gen}.{self.rid}"

    def ep_key(self) -> str:
        return f"serve.ep.{self.ns}.g{self.gen}.{self.rid}"

    def _hb_value(self) -> bytes:
        """``<seq>:<wall>`` — the sequence the accrual sweep reads plus
        this process's wall clock, the round-trip clock sample the
        router's trace assembler estimates per-worker offsets from."""
        return f"{self.seq}:{time.time():.6f}".encode()

    def _post_heartbeats(self) -> None:
        while not self._hb_stop.wait(self.hb_interval_s):
            try:
                self._kv.set(self.hb_key(), self._hb_value())
            except Exception as e:  # noqa: BLE001 — a KV blip must not
                logger.warning(     # kill the poster; stale age is the
                    "replica %d heartbeat post failed: %s",  # signal
                    self.rid, e)

    def _weight_gate(self, timeout_s: float = 30.0) -> None:
        """Adopt the channel's newest PUBLISHED version before taking
        traffic — the respawn re-admission gate, enforced where the
        weights land. A failed poll (a corrupt chunk, a lapped slot)
        is logged and retried until ``timeout_s``."""
        if self.subscriber is None:
            return
        target = self.subscriber.peek_version()
        if target is None:
            return                    # nothing published yet
        deadline = time.monotonic() + timeout_s
        while (self.executor.params_version or 0) < target:
            try:
                got = self.subscriber.poll()
                if got is not None:
                    self.executor.swap_params(got[1], version=got[0])
            except Exception as e:  # noqa: BLE001
                logger.warning("replica %d weight gate poll failed "
                               "(%s); retrying", self.rid, e)
            if (self.executor.params_version or 0) >= target:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"replica {self.rid} could not adopt weight "
                    f"version {target} within {timeout_s:.0f}s")
            time.sleep(0.05)

    def _load_kernels(self) -> None:
        """Load K1's library before warm-up (timed on its own; it was
        built by the parent before any worker spawned, so this is a
        load, not a compile). A failure kills the worker here."""
        if self.executor.kernel != "cuda":
            return
        from ..ops import paged
        t0 = time.perf_counter()
        paged._lib()
        self.startup["kernel_s"] = time.perf_counter() - t0

    def start(self) -> "ReplicaWorker":
        """Load K1, warm up (every graph captured), pass the weight gate,
        open the endpoint, start heartbeating, REGISTER (the
        registration key doubles as the ready signal the router waits
        on)."""
        self._load_kernels()
        t0 = time.perf_counter()
        self.batcher.warmup()
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        self.startup["capture_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._weight_gate()
        if self.subscriber is not None:
            self.startup["gate_s"] = time.perf_counter() - t0
            self.batcher.attach_weights(self.subscriber)
            self.endpoint.subscriber = self.subscriber
        self.endpoint.start()
        self.batcher.start()
        self.startup["t_ready"] = time.time()
        self.endpoint.extra_health["startup"] = dict(self.startup)
        if self._kv is not None:
            self._kv.set(self.hb_key(), self._hb_value())
            self._hb_thread = threading.Thread(
                target=self._post_heartbeats, daemon=True,
                name=f"hvd-replica-hb-{self.rid}")
            self._hb_thread.start()
            self._kv.set(self.ep_key(), json.dumps({
                "host": self.endpoint.address[0],
                "port": self.endpoint.address[1],
                "pid": os.getpid(),
                "weights_version": self.executor.params_version,
                "startup": self.startup,
                "t": time.time()}).encode())
        return self

    def drain(self, timeout_s: float = 10.0) -> None:
        """Stop admitting, finish the in-flight tail, stop. New submits
        are rejected with retry-after at the endpoint (never silently
        dropped) while the tail resolves."""
        self.draining = True
        self.batcher.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.queue.depth() == 0 and not self.batcher._active:
                break
            time.sleep(0.05)
        self.close()
        self._drained.set()

    def close(self) -> None:
        self._hb_stop.set()
        self.batcher.stop()
        self.endpoint.close()
        if self.subscriber is not None:
            self.subscriber.close()
        if self._kv is not None:
            self._kv.close()
        if self._events_f is not None:
            self._events_f.close()

    def run_forever(self) -> int:
        """Block until the scheduler dies (rc 1 — the supervisor
        respawns) or a drain COMPLETES (rc 0 — exiting on the mere
        start of a drain would kill the in-flight tail the drain
        exists to finish)."""
        while True:
            if self._drained.is_set():
                return 0
            if self.draining:
                time.sleep(0.1)
                continue
            if not self.batcher.alive():
                logger.error("replica %d scheduler died — exiting so "
                             "the router can respawn a fresh process",
                             self.rid)
                return 1
            time.sleep(0.2)


def main(argv=None) -> int:
    t_main = time.time()
    cfg_raw = os.environ.get("HOROVOD_SERVE_WORKER_CFG")
    if not cfg_raw:
        print("serve worker: HOROVOD_SERVE_WORKER_CFG is not set",
              file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO)
    cfg = dict(json.loads(cfg_raw), _t_main=t_main)
    try:
        worker = ReplicaWorker(cfg)
    except RuntimeError as e:
        if "CUDA is not available" not in str(e):
            raise
        # the card was asked for (no "device", or "cuda") and is absent:
        # a worker never serves on the CPU unless told to
        print(f"serve worker: {e}", file=sys.stderr)
        return 1

    def _sigterm(signum, frame):
        logger.info("replica %d: SIGTERM — draining", worker.rid)
        threading.Thread(target=worker.drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    worker.start()
    logger.info("replica %d ready on %s:%d (gen %d, weights v%s, "
                "device %s, startup %s)", worker.rid,
                worker.endpoint.address[0], worker.endpoint.address[1],
                worker.gen, worker.executor.params_version,
                worker.device, json.dumps(worker.startup))
    return worker.run_forever()


if __name__ == "__main__":
    sys.exit(main())
