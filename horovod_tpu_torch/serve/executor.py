"""Model executor: the one fixed-shape step of the server.

The port of ``horovod_tpu/serve/executor.py``. Drives a decode-mode
model (models/llama.py or models/gpt.py) at **fixed shapes**: every call
is ``[max_batch, T]`` tokens with per-row positions, an update mask and a
per-row emitting index, where T is 1 (decode), one of the prefill
buckets, or ``spec_k + 1`` (the speculative verify step). Batch
membership is data, not shape, so sequences join and leave between
iterations without ever adding a program: the no-recompile contract the
continuous batcher is built on.

**The captured step.** Where the reference jits one program per shape,
the port captures one CUDA graph per signature ``(kind, T, sampled)``:
the reference covers greedy and sampled batches with one program through
``lax.cond``, the port decides on the host (from its copy of the
temperatures) and keeps a greedy and a sampled graph. Each ``(kind, T)``
owns static buffers: one int32 word buffer that holds every host input
(tokens, positions, mask, last_idx, the four sampling arrays, n_draft,
block tables; floats as their bits), filled by ONE host-to-device copy a
step from a pinned host buffer; the verify step's ``[B, T - 1, V]``
draft-probs input (on the device); and the outputs: the tokens, read
back by ONE device-to-host copy, and ``last_logits`` (and a drafter's
``probs``), left on the device. On a CUDA device a signature's first
use runs the body once eagerly on a side stream (the kernel build,
cuBLAS handles, K1's shared-memory attributes) and then captures it;
every use, the first included, is one replay. A capture that fails
raises naming the signature: nothing falls back to running the step
eagerly. On the CPU the same buffers feed the same body with no
capture, so the CPU tests see the card's ownership rules: ``probs`` and
``last_logits`` are the executor's buffers, overwritten by the next step
of the same signature. :meth:`jit_cache_size` counts the graphs (on the
CPU, the bound signatures). The caches are persistent tensors updated
in place, so a replay writes the live cache; K1's workspace, allocated
inside the capture, lives in the graphs' memory pool, one pool shared
by the executor's graphs (see :meth:`ShardedExecutor._capture`).

Two cache layouts, chosen by the model config:

* **paged** (``kv_block_size > 0``): every step takes block tables, and
  attention runs through the kernel resolved ONCE at build
  (``HOROVOD_SERVE_KERNEL`` via ``ops.paged.resolve_kernel``: the CUDA
  kernel K1 on a CUDA device, the plain version on the CPU), stamped into
  the model config; a head dim the CUDA kernel does not take is refused
  then. The ``kernel`` label on ``hvd_serve_step_ms`` names it. K1's
  launch count (``paged_attention_fused.launches``) grows by the number
  of launches a graph's capture made on every replay.
* **slotted** (``kv_block_size == 0``): per-row cache rows and the plain
  attention (``kernel="reference"``), as the reference's slotted
  executors run XLA: the speculative drafter's layout.

Token selection runs on the device: temperature / top-p with per-request
seeds, carried as row data (``sample=``), greedy being the
``temperature == 0`` case (an all-greedy batch takes the argmax with no
sort). Only the per-row emitting position's logits are computed
(``logits_idx`` gathers hidden states before the lm_head). A
``role="draft"`` executor also returns the distribution each token was
drawn from, on the device, and labels its metrics ``role="draft"`` so
the target's families stay its own. The verify step (``kind="verify"``)
computes every position's logits and applies the rejection-sampling
accept rule (``ops.paged.speculative_accept``).

**Hot weight swap** (:meth:`swap_params`): the reference's version
fence. Every step holds the executor's lock, so a swap lands only
between steps and no step mixes two versions; versions only rise. The
new weights are staged on the device outside the lock and copied INTO
the live parameters under it, so the graphs, which hold the parameters'
addresses, replay the new weights and no graph is added.

**KV byte paths** (the crc ledger, the chaos ``serve.kv`` fault and the
KV tier): :meth:`kv_block_bytes` / :meth:`kv_slot_bytes` read one (block
or row, position range) of every cache leaf, in the reference's leaf
order (``kv_cache.leaf_order``), as the bytes the reference's
``np.asarray(leaf[i, start:stop]).tobytes()`` gives (a bf16 pool is read
as raw bytes: the same bits). :meth:`kv_read` reads many such pairs in
ONE gather over the cache arena and ONE device-to-host copy into a
pinned buffer of the read's own, returned as memoryviews of it, byte for
byte what the per-pair reads give: the batcher's ledger takes one such
read a step, where the reference reads per (row, leaf).
:meth:`install_kv_blocks`, :meth:`corrupt_kv_block` and
:meth:`corrupt_kv_slot` write into the live pools in place, under the
step lock (the graphs hold the pools' addresses), never past a pool's
last slot into its sink row.

**Streams.** On a card each executor issues all of its device work — its
steps, captures, KV reads and writes and swaps — on a stream of its own
(:attr:`ShardedExecutor.stream`), and every host read it makes waits on
that stream only, so two replicas that share one card in one process
never wait for each other's steps. A batcher runs its whole scheduling
iteration on its target's stream, and its drafter takes the same stream
(the draft distributions reach the verify step on the device). K1's
launches are counted per executor (:attr:`ShardedExecutor.k1_launches`)
and in the process-wide ``paged_attention_fused.launches``, through
``ops.paged.count_launches`` / ``capture_window``: what a capture counts
is the capturing thread's own, whatever other executors replay
meanwhile.

Sharding over a mesh is a later slice.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..obs import metrics as obs_metrics
from ..ops import paged as ops_paged
from ..ops.paged import (STREAM_DRAFT, STREAM_SAMPLE, check_head_dim,
                         resolve_kernel, sample_with_probs,
                         speculative_accept)

logger = logging.getLogger("horovod_tpu_torch")

#: the step kinds, each with its own latency series
KINDS = ("prefill", "decode", "verify")


class _Signature:
    """The static buffers of one ``(kind, T)`` step shape, shared by its
    greedy and sampled graphs.

    ``words`` (int32, on the device) holds every host input, packed;
    ``host`` is its pinned staging copy. The named views below read
    ``words`` in place (floats through a bit view)."""

    def __init__(self, ex: "ShardedExecutor", kind: str, T: int):
        B, dev = ex.max_batch, ex.device
        nblk = ex.blocks_per_seq
        self.kind, self.T = kind, T
        sizes = (("tokens", B * T), ("positions", B), ("mask", B),
                 ("last_idx", B), ("temperature", B), ("top_p", B),
                 ("seed", B), ("ctr", B), ("n_draft", B),
                 ("tables", B * nblk))
        self.slices: Dict[str, slice] = {}
        off = 0
        for name, n in sizes:
            self.slices[name] = slice(off, off + n)
            off += n
        pin = dev.type == "cuda"
        self.words = torch.zeros(off, dtype=torch.int32, device=dev)
        self.host = torch.zeros(off, dtype=torch.int32, pin_memory=pin)
        self.host_np = self.host.numpy()
        w = {name: self.words[s] for name, s in self.slices.items()}
        self.tokens = w["tokens"].view(B, T)
        self.positions, self.mask_words = w["positions"], w["mask"]
        self.last_idx, self.seed, self.ctr = (w["last_idx"], w["seed"],
                                              w["ctr"])
        self.n_draft = w["n_draft"]
        self.temperature = w["temperature"].view(torch.float32)
        self.top_p = w["top_p"].view(torch.float32)
        self.tables = w["tables"].view(B, nblk)
        # outputs: the tokens (the verify step's emitted [B, T] then
        # n_accept [B]) in one int32 buffer, read back by one copy
        n_out = B * (T + 1) if kind == "verify" else B
        self.out = torch.zeros(n_out, dtype=torch.int32, device=dev)
        self.out_host = torch.zeros(n_out, dtype=torch.int32,
                                    pin_memory=pin)
        V, ldt = ex.vocab_size, ex.model.cfg.logits_dtype
        self.logits = torch.zeros((B, T, V) if kind == "verify" else (B, V),
                                  dtype=ldt, device=dev)
        self.probs = (torch.zeros(B, V, device=dev)
                      if ex.role == "draft" and kind != "verify" else None)
        self.draft_probs = (torch.zeros(B, T - 1, V, device=dev)
                            if kind == "verify" else None)
        #: sampled -> CUDA graph (None on the CPU: the signature is bound)
        self.graphs: Dict[bool, Optional[torch.cuda.CUDAGraph]] = {}
        #: sampled -> K1 launches one replay makes
        self.k1_launches: Dict[bool, int] = {}

    def stage(self, tokens, positions, mask, last_idx, block_tables,
              sample, n_draft) -> None:
        """Pack the host inputs into ``host`` and copy them to ``words``
        (one copy; asynchronous from pinned memory, stream-ordered before
        the step, and the step's readback fences it before ``host`` is
        written again)."""
        h, s = self.host_np, self.slices
        h[s["tokens"]] = np.asarray(tokens, np.int32).reshape(-1)
        h[s["positions"]] = positions
        h[s["mask"]] = np.asarray(mask, bool)
        h[s["last_idx"]] = last_idx
        if sample is None:
            h[s["temperature"]] = np.float32(0).view(np.int32)
            h[s["top_p"]] = np.float32(1).view(np.int32)
            h[s["seed"]] = 0
            h[s["ctr"]] = 0
        else:
            h[s["temperature"]] = np.asarray(
                sample["temperature"], np.float32).view(np.int32)
            h[s["top_p"]] = np.asarray(sample["top_p"],
                                       np.float32).view(np.int32)
            h[s["seed"]] = (np.asarray(sample["seed"]).astype(np.int64)
                            & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            h[s["ctr"]] = sample["ctr"]
        h[s["n_draft"]] = 0 if n_draft is None else n_draft
        if block_tables is not None:
            h[s["tables"]] = np.asarray(block_tables, np.int32).reshape(-1)
        self.words.copy_(self.host, non_blocking=True)

    def read(self) -> np.ndarray:
        """The output tokens on the host (one copy, which waits for the
        step)."""
        self.out_host.copy_(self.out)
        return self.out_host.numpy().copy()


class ShardedExecutor:
    """Owns the model, the device KV caches and the captured steps."""

    def __init__(self, model: Any, *, max_batch: int, max_len: int,
                 device=None, mesh=None, partition_rules=None,
                 replica_id: Optional[int] = None, role: str = "target"):
        if mesh is not None or partition_rules is not None:
            raise NotImplementedError(
                "mesh/partition_rules: sharded serving is not ported yet")
        if role not in ("target", "draft"):
            raise ValueError(f"role must be 'target'|'draft'; got {role!r}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        cfg = model.cfg
        if not cfg.decode:
            raise ValueError("the executor serves a decode model: set "
                             "decode=True (slotted cache) or "
                             "kv_block_size > 0 (paged)")
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"max_len {max_len} exceeds the model's max_seq_len "
                f"{cfg.max_seq_len}")
        self.device = resolve_device(device)
        self.role = role
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_block_size = int(cfg.kv_block_size or 0)
        self.kv_pool_blocks = int(cfg.kv_pool_blocks or 0)
        self.paged = self.kv_block_size > 0
        #: vocab width: the verify step's draft-probs row shape
        self.vocab_size = int(cfg.vocab_size)
        if self.paged:
            self.kernel = resolve_kernel(cfg.decode_kernel,
                                         device=self.device)
            if self.kernel == "cuda":
                # refuse here, not at the first serve step
                check_head_dim(cfg.head_dim)
            #: fixed block-table width: enough entries to address max_len
            self.blocks_per_seq = -(-max_len // self.kv_block_size)
            if self.kv_pool_blocks < self.blocks_per_seq:
                raise ValueError(
                    f"kv_pool_blocks {self.kv_pool_blocks} cannot cover "
                    f"one max_len sequence ({self.blocks_per_seq} blocks "
                    f"of {self.kv_block_size})")
            cfg.decode_kernel = self.kernel
        else:
            # the slotted layout has no kernel: the plain attention
            self.kernel = "reference"
            self.blocks_per_seq = 0
        self.model = model.to(self.device).eval()
        self.cache = self.model.new_cache(max_batch)
        # -- the KV byte paths: every leaf of the arena as raw bytes,
        # [leaves, rows, row_bytes]; (i, p) of a leaf is row i * n1 + p
        arena = self.cache.arena
        self._kv_n0 = self.kv_pool_blocks if self.paged else max_batch
        self._kv_n1 = self.kv_block_size if self.paged else cfg.max_seq_len
        self._kv_bytes = arena.reshape(arena.shape[0], arena.shape[1],
                                       -1).view(torch.uint8)
        self._kv_idx_host: Optional[torch.Tensor] = None
        #: batched KV reads (:meth:`kv_read`): each one gather and one
        #: device-to-host copy; and the bytes they moved
        self.kv_reads = 0
        self.kv_read_bytes = 0
        #: ms of each recent batched read (host clock, its copy included)
        self.kv_read_ms: "deque[float]" = deque(maxlen=4096)
        #: logits of the most recent step: the executor's buffer for its
        #: signature, [max_batch, V], or [max_batch, T, V] after a verify
        self.last_logits: Optional[torch.Tensor] = None
        self._sigs: Dict[Tuple[str, int], _Signature] = {}
        #: (kind, T, sampled) -> ms of its capture (warm-up run included)
        self.capture_ms: Dict[Tuple[str, int, bool], float] = {}
        self._graph_pool = None
        self._side_stream = None
        #: the stream every device operation of this executor runs on (a
        #: card; None on the CPU). A batcher sets its drafter's to its
        #: target's, so the pair's work is ordered on one stream.
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        #: K1 launches of this executor's replays (its share of
        #: ``paged_attention_fused.launches``)
        self.k1_launches = 0
        # -- the swap / version fence: every step holds this lock, so a
        # swap lands only between steps and no step mixes two versions
        self._lock = threading.Lock()
        self.params_version: Optional[int] = None
        self.swaps = 0
        #: the newest adoption's ms: in all, staging, and the fenced copy
        self.last_swap: Dict[str, Any] = {}
        #: params_version the most recent step ran under (set inside the
        #: lock): what lets a caller see a swap land between two steps
        self.last_step_version: Optional[int] = None
        # -- metrics --
        self.steps = 0
        #: steps by kind (prefill / decode / verify)
        self.steps_by_kind = {k: 0 for k in KINDS}
        #: steps that ran as a graph replay (a card)
        self.replays = 0
        self.tokens_out = 0
        #: recent step latencies by kind
        self.step_latencies_ms = {k: deque(maxlen=1024) for k in KINDS}
        self._tok_window: "deque[Tuple[float, int]]" = deque(maxlen=1024)
        #: distinct (kind, T) entry points actually executed
        self.signatures: Set[Tuple[str, int]] = set()
        #: fleet replica identity (None = standalone); ``serve.fleet.
        #: Replica`` refuses an executor whose id is not its own
        self.replica_id = replica_id
        # standalone executors claim their families fresh; a fleet
        # replica's get {replica=...}-labeled children, so one replica's
        # rebuild never clobbers its siblings' series
        R = obs_metrics.get_registry()
        rl = {} if replica_id is None else {"replica": str(replica_id)}
        if role == "draft":
            rl = dict(rl, role="draft")
        if replica_id is None and role == "target":
            # only a standalone target claims the families fresh: a
            # drafter is built next to a target and must not clobber its
            # series
            R.unregister("hvd_serve_step_ms")
            R.unregister("hvd_serve_tokens_total")
        self._m_step_ms = {
            k: R.histogram("hvd_serve_step_ms",
                           "executor step latency by kind (ms)",
                           dict(rl, kind=k, kernel=self.kernel))
            for k in KINDS}
        self._m_tokens = R.counter("hvd_serve_tokens_total",
                                   "tokens generated", rl or None)
        # get-or-create: the swap series is shared by every executor
        self._m_swap_ms = R.histogram(
            "hvd_weight_swap_ms",
            "hot weight swap: new params staged + adopted (ms)")
        logger.info("serve executor: role=%s kernel=%s paged=%s device=%s",
                    role, self.kernel, self.paged, self.device)

    # -- the one step --------------------------------------------------------
    def on_stream(self):
        """Context manager: the executor's stream as the current stream
        (a card), nothing on the CPU. Every device operation of the
        executor runs inside it; a batcher runs its iteration inside
        it."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _signature(self, kind: str, T: int) -> _Signature:
        sig = self._sigs.get((kind, T))
        if sig is None:
            if kind == "verify" and T < 2:
                raise ValueError(f"a verify step needs T >= 2; got {T}")
            with self.on_stream():
                sig = self._sigs[(kind, T)] = _Signature(self, kind, T)
        return sig

    def verify_draft_probs(self, T: int) -> torch.Tensor:
        """The verify signature's static ``[max_batch, T - 1, V]``
        draft-probs input. A caller that writes the proposals'
        distributions here and passes it as ``draft_probs`` saves the step
        a copy; it is overwritten by the next such caller."""
        return self._signature("verify", T).draft_probs

    def step(self, tokens: np.ndarray, positions: np.ndarray,
             mask: np.ndarray, last_idx: np.ndarray, *,
             kind: str = "decode",
             block_tables: Optional[np.ndarray] = None,
             sample: Optional[Dict[str, np.ndarray]] = None,
             draft_probs: Optional[torch.Tensor] = None,
             n_draft: Optional[np.ndarray] = None):
        """Run one fixed-shape forward step: one graph replay on a card.

        tokens [max_batch, T] int32; positions/last_idx [max_batch];
        mask [max_batch] bool; block_tables [max_batch, blocks_per_seq]
        int32 (paged executors only). ``sample``: per-row
        ``temperature`` / ``top_p`` / ``seed`` / ``ctr`` arrays
        ``[max_batch]``; None is greedy.

        Returns, valid where ``mask`` is set:

        * ``kind="prefill"`` / ``"decode"``: the next token per row,
          ``[max_batch]`` int32, drawn from the logits at ``last_idx``. A
          draft executor returns ``(tokens, probs)``, ``probs
          [max_batch, V]`` the filtered distribution each token was drawn
          from: the executor's device buffer, overwritten by the next
          step of this signature.
        * ``kind="verify"``: ``(emitted [max_batch, T] int32, n_accept
          [max_batch] int32)``: the accept rule applied against
          ``draft_probs [max_batch, T-1, V]`` (a device tensor, ideally
          :meth:`verify_draft_probs`) with per-row real proposal counts
          ``n_draft``.
        """
        if kind not in KINDS:
            raise ValueError(f"step kind must be one of {KINDS}; got "
                             f"{kind!r}")
        if self.paged and block_tables is None:
            raise ValueError("a paged executor step needs block_tables")
        t0 = time.perf_counter()
        T = int(tokens.shape[1])
        sig = self._signature(kind, T)
        self.signatures.add((kind, T))
        sampled = sample is not None and bool(
            np.any(np.asarray(sample["temperature"]) > 0))
        with self._lock, self.on_stream():
            self.last_step_version = self.params_version
            sig.stage(tokens, positions, mask, last_idx,
                      block_tables if self.paged else None, sample, n_draft)
            if kind == "verify" and sampled:
                if draft_probs is None:
                    sig.draft_probs.zero_()
                elif draft_probs is not sig.draft_probs:
                    sig.draft_probs.copy_(draft_probs)
            self._run(sig, sampled)
            # the readback doubles as the step's completion fence
            out = sig.read()
        self.last_logits = sig.logits
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.steps += 1
        self.steps_by_kind[kind] += 1
        self.step_latencies_ms[kind].append(dt_ms)
        self._m_step_ms[kind].observe(dt_ms)
        n_tok = int(np.sum(mask))
        self.tokens_out += n_tok
        self._m_tokens.inc(n_tok)
        self._tok_window.append((time.perf_counter(), n_tok))
        if kind == "verify":
            B = self.max_batch
            return out[:B * T].reshape(B, T), out[B * T:]
        if self.role == "draft":
            return out, sig.probs
        return out

    def _body(self, sig: _Signature, sampled: bool) -> None:
        """The step on ``sig``'s static buffers: reads its inputs, writes
        its outputs and the caches in place. Fixed shapes, no host sync:
        what a CUDA graph captures. Callable alone (eagerly) for tests."""
        kw = {"block_tables": sig.tables} if self.paged else {}
        mask = sig.mask_words != 0
        args = ((sig.temperature, sig.top_p, sig.seed, sig.ctr) if sampled
                else (None,) * 4)
        with torch.inference_mode():
            if sig.kind == "verify":
                logits = self.model(sig.tokens, sig.positions, mask,
                                    cache=self.cache, **kw)
                emitted, n_acc = speculative_accept(
                    sig.tokens, sig.draft_probs, logits, sig.n_draft,
                    *args, sampled=sampled)
                B, T = sig.tokens.shape
                sig.out[:B * T].view(B, T).copy_(emitted)
                sig.out[B * T:].copy_(n_acc)
            else:
                logits = self.model(sig.tokens, sig.positions, mask,
                                    cache=self.cache,
                                    logits_idx=sig.last_idx, **kw)[:, 0]
                nxt, probs = sample_with_probs(
                    logits, *args,
                    stream=STREAM_DRAFT if self.role == "draft"
                    else STREAM_SAMPLE, sampled=sampled)
                sig.out.copy_(nxt)
                if sig.probs is not None:
                    sig.probs.copy_(probs)
            sig.logits.copy_(logits)

    def _run(self, sig: _Signature, sampled: bool) -> None:
        """One replay of the signature's graph, captured at its first use
        (a card); the body on the static buffers (the CPU)."""
        if self.device.type != "cuda":
            sig.graphs.setdefault(sampled, None)
            self._body(sig, sampled)
            return
        graph = sig.graphs.get(sampled)
        if graph is None:
            graph = self._capture(sig, sampled)
        graph.replay()
        self.replays += 1
        n = sig.k1_launches[sampled]
        self.k1_launches += n
        ops_paged.count_launches(n)

    def _capture(self, sig: _Signature, sampled: bool
                 ) -> torch.cuda.CUDAGraph:
        """Warm up, then capture the body of ``(sig, sampled)``.

        The warm-up is one eager run on a side stream (with the step's
        real inputs: the body is idempotent, it writes the same K/V it
        attends over), then a wait on that stream alone (never the whole
        device: a sibling executor may be replaying). The capture runs on
        the same stream, ``capture_error_mode="thread_local"``: the steps
        of an executor run on one thread under its lock, and another
        thread's CUDA work (a swap staging weights, a sibling replica's
        steps) touches neither this stream nor the graphs' pool, so it
        must not invalidate the capture. K1's wrapper calls inside the
        capture are counted in this thread's ``capture_window``: what
        each replay of the graph launches, whatever other threads
        launch meanwhile. Every
        graph of the executor allocates from ONE pool: a capture
        allocates only the step's intermediates (the outputs and caches
        are allocated outside it), which are dead when it ends, and
        replays run one at a time in stream order, so a graph may reuse
        another's intermediates whatever the order of replays. K1's
        workspace is such an intermediate: it lives as long as the
        graphs. Raises ``RuntimeError`` naming the signature on any
        failure; nothing runs the step eagerly in its place, and later
        captures allocate from a fresh pool."""
        name = f"(kind={sig.kind!r}, T={sig.T}, sampled={sampled})"
        t0 = time.perf_counter()
        try:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            side = self._side_stream
            cur = torch.cuda.current_stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._body(sig, sampled)
            cur.wait_stream(side)
            side.synchronize()
            graph = torch.cuda.CUDAGraph()
            # a capture launches nothing: its wrapper calls are what each
            # replay will launch, counted apart from every other thread's
            try:
                with ops_paged.capture_window() as window, \
                        torch.cuda.stream(side):
                    graph.capture_begin(pool=self._graph_pool,
                                        capture_error_mode="thread_local")
                    try:
                        self._body(sig, sampled)
                    finally:
                        graph.capture_end()
            except Exception:
                # a failed capture leaves its pool recording: later
                # captures take a fresh one
                self._graph_pool = None
                raise
            n_k1 = window.n
        except Exception as e:  # noqa: BLE001 — re-raised, named
            raise RuntimeError(
                f"CUDA graph capture failed for step signature {name}: "
                f"{type(e).__name__}: {e}") from e
        sig.graphs[sampled] = graph
        sig.k1_launches[sampled] = n_k1
        self.capture_ms[(sig.kind, sig.T, sampled)] = \
            (time.perf_counter() - t0) * 1000.0
        logger.info("serve executor (role=%s): captured %s in %.1f ms",
                    self.role, name, self.capture_ms[(sig.kind, sig.T,
                                                      sampled)])
        return graph

    def jit_cache_size(self) -> int:
        """Captured graphs (on the CPU, bound ``(kind, T, sampled)``
        signatures): the count the churn tests hold flat after
        warm-up."""
        return sum(len(sig.graphs) for sig in self._sigs.values())

    def copy_kv_block(self, src: int, dst: int) -> None:
        """Device-side copy of pool block ``src`` onto ``dst`` in every
        cache leaf (one copy over the arena) — the copy-on-write body
        behind partial prefix block sharing (serve/prefix.py). Paged
        executors only."""
        if not self.paged:
            raise ValueError("copy_kv_block needs a paged executor")
        self._check_rows("copy_kv_block", [src, dst])
        if src == dst:
            return
        bs = self.kv_block_size
        with self._lock, self.on_stream():   # never tear a step
            self._kv_bytes[:, dst * bs:(dst + 1) * bs].copy_(
                self._kv_bytes[:, src * bs:(src + 1) * bs])

    # -- KV byte paths (crc ledger, serve.kv chaos, KV tier) -----------------
    def _cache_leaves(self) -> List[torch.Tensor]:
        """The cache leaves in the reference's flatten order
        (``kv_cache.leaf_order``: layers sorted by name, k before v):
        ``[kv_pool_blocks, kv_block_size, H_kv, D]`` pools when paged,
        else ``[max_batch, max_seq_len, H_kv, D]`` rows."""
        arena = self.cache.arena
        n = self._kv_n0 * self._kv_n1
        return [arena[j, :n].view(self._kv_n0, self._kv_n1,
                                  *arena.shape[2:])
                for j in range(arena.shape[0])]

    def _check_rows(self, what: str, idxs) -> None:
        for i in idxs:
            if not 0 <= int(i) < self._kv_n0:
                raise ValueError(
                    f"{what}: index {i} outside [0, {self._kv_n0}) "
                    f"({'pool blocks' if self.paged else 'cache rows'})")

    def _check_range(self, what: str, i: int, start: int,
                     stop: int) -> None:
        self._check_rows(what, [i])
        if not 0 <= start <= stop <= self._kv_n1:
            raise ValueError(f"{what}: positions [{start}, {stop}) outside "
                             f"[0, {self._kv_n1}]")

    def _leaf_slices(self, i: int, start: int, stop: int) -> list:
        """Host bytes of positions ``[start, stop)`` of block / row ``i``
        in each cache leaf (leaf order): one strided slice of the arena,
        one copy."""
        self._check_range("kv read", i, start, stop)
        n1 = self._kv_n1
        with self._lock, self.on_stream():
            arr = self._kv_bytes[:, i * n1 + start:i * n1 + stop].cpu()
        arr = arr.numpy()
        return [arr[j].tobytes() for j in range(arr.shape[0])]

    def kv_slot_bytes(self, slot: int, start: int, stop: int) -> list:
        """Host bytes of positions ``[start, stop)`` of ``slot``'s row in
        each cache leaf (leaf order) — what the per-slot crc ledger
        (``SlotKVCache.crc_update`` / ``crc_check``) streams over."""
        return self._leaf_slices(slot, start, stop)

    def kv_block_bytes(self, block: int, start: int, stop: int) -> list:
        """Paged sibling of :meth:`kv_slot_bytes`: host bytes of positions
        ``[start, stop)`` of pool block ``block`` in each cache leaf —
        what the per-block crc ledger (``BlockPool.crc_stream`` /
        ``crc_check``) and the KV tier's demotion read."""
        return self._leaf_slices(block, start, stop)

    def _staging(self, buf: Optional[torch.Tensor], n: int,
                 dtype) -> torch.Tensor:
        """``buf``, or a larger host buffer (pinned on a card) when it
        holds fewer than ``n`` elements. Reused across reads: every read
        that fills one ends in a synchronous copy, so no copy is in
        flight when it is reused."""
        if buf is not None and buf.numel() >= n:
            return buf
        size = max(n, 2 * (buf.numel() if buf is not None else 0), 1024)
        return torch.empty(size, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def reserve_kv_read(self, positions: int) -> None:
        """Warm :meth:`kv_read`'s host buffers for a read of ``positions``
        positions of every leaf, ahead of traffic. Pinning host memory is
        slow, and on a card it holds the driver while every other
        thread's CUDA calls wait (a sibling replica's steps too): a
        batcher with the crc ledger reserves its largest read at warm-up,
        and the pinned block then stays in torch's host cache."""
        nleaf, rb = self._kv_bytes.shape[0], self._kv_bytes.shape[2]
        with self._lock:
            self._kv_idx_host = self._staging(self._kv_idx_host,
                                              int(positions), torch.int64)
            if self.device.type == "cuda":
                torch.empty(nleaf * int(positions) * rb, dtype=torch.uint8,
                            pin_memory=True)

    def kv_read(self, pairs: Sequence[Tuple[int, int, int]]
                ) -> List[List[memoryview]]:
        """The bytes of many ``(block or row, start, stop)`` pairs of
        every cache leaf: ``out[j][leaf]`` equals
        ``kv_block_bytes(*pairs[j])[leaf]`` (paged) or
        ``kv_slot_bytes(*pairs[j])[leaf]`` (slotted) byte for byte.

        One gather over the cache arena and one device-to-host copy
        into a host buffer of the read's own (pinned on a card, from
        torch's host cache: one host sync), whatever the number of pairs
        and leaves; the position index reaches the card by one
        asynchronous copy from a pinned buffer. The bytes come back as
        memoryviews of that buffer, which lives as long as they do: no
        per-leaf copy and no fresh host pages (a step's ledger reads
        ~11,000 leaf ranges at a full prefill wave, and faulting in that
        many fresh pages stalled two replicas' schedulers on each other).
        This is how the batcher's crc ledger reads a step's writes and a
        retiring request's blocks, where the reference reads per (row,
        leaf)."""
        t0 = time.perf_counter()
        n1 = self._kv_n1
        spans = []
        for i, a, b in pairs:
            self._check_range("kv_read", i, a, b)
            spans.append(np.arange(a, b, dtype=np.int64) + int(i) * n1)
        nleaf = self._kv_bytes.shape[0]
        idx = np.concatenate(spans) if spans else np.zeros(0, np.int64)
        if idx.size == 0:
            return [[memoryview(b"")] * nleaf for _ in pairs]
        rb = self._kv_bytes.shape[2]
        n_out = nleaf * idx.size * rb
        with self._lock, self.on_stream():
            ih = self._kv_idx_host = self._staging(self._kv_idx_host,
                                                   idx.size, torch.int64)
            ih.numpy()[:idx.size] = idx
            ix = ih[:idx.size].to(self.device, non_blocking=True)
            gathered = self._kv_bytes[:, ix]           # [leaves, P, rb]
            host = torch.empty(n_out, dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")
            host.view(gathered.shape).copy_(gathered)
        arr = host.numpy().reshape(nleaf, -1)
        leaves = [memoryview(arr[j]) for j in range(nleaf)]
        out, off = [], 0
        for i, a, b in pairs:
            lo, hi = off * rb, (off + b - a) * rb
            out.append([leaf[lo:hi] for leaf in leaves])
            off += b - a
        self.kv_reads += 1
        self.kv_read_bytes += n_out
        self.kv_read_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def install_kv_blocks(self, blocks: "list[int]",
                          block_leaf_bytes: "list[list[bytes]]",
                          lengths: "list[int]") -> None:
        """Write KV bytes into pool blocks ``blocks``:
        ``block_leaf_bytes[j]`` carries one bytes object per cache leaf
        (leaf order, the order :meth:`kv_block_bytes` reads) for block
        ``blocks[j]``, covering positions ``[0, lengths[j])``; positions
        past ``lengths[j]`` land as zeros (unreachable by the positional
        mask). Byte counts are validated against the leaf dtype and shape
        before anything lands (the reference's messages). One copy to the
        card and one indexed write over the arena, in place under the
        step lock: the graphs hold the pools' addresses, and the sink rows
        are never written."""
        if not self.paged:
            raise RuntimeError("install_kv_blocks is paged-only")
        if not blocks:
            return
        bs = self.kv_block_size
        leaves = self._cache_leaves()
        if any(len(lb) != len(leaves) for lb in block_leaf_bytes):
            raise ValueError(
                f"install_kv_blocks: payload leaf counts "
                f"{[len(lb) for lb in block_leaf_bytes]} do not match the "
                f"{len(leaves)} cache leaves — the sender's model layout "
                f"does not match")
        self._check_rows("install_kv_blocks", blocks)
        if len(set(int(b) for b in blocks)) != len(blocks):
            raise ValueError(f"install_kv_blocks: blocks {list(blocks)} "
                             f"name a block twice")
        tail = tuple(leaves[0].shape[2:])
        dt = str(leaves[0].dtype).replace("torch.", "")
        rb = self._kv_bytes.shape[2]
        staged = np.zeros((len(leaves), len(blocks), bs, rb), np.uint8)
        for j, (lb, length) in enumerate(zip(block_leaf_bytes, lengths)):
            length = int(length)
            for li, raw in enumerate(lb):
                if len(raw) != length * rb or not 0 <= length <= bs:
                    raise ValueError(
                        f"install_kv_blocks: leaf payload of {len(raw)} "
                        f"bytes != expected {length * rb} for {length} "
                        f"positions of {tail} {dt} — incompatible pool "
                        f"layouts")
                staged[li, j, :length] = np.frombuffer(
                    raw, np.uint8).reshape(length, rb)
        rows = (np.asarray(blocks, np.int64)[:, None] * bs
                + np.arange(bs, dtype=np.int64)[None]).reshape(-1)
        src = torch.from_numpy(staged.reshape(len(leaves), -1, rb))
        with self._lock, self.on_stream():
            ix = torch.from_numpy(rows).to(self.device)
            self._kv_bytes[:, ix] = src.to(self.device)

    def _corrupt(self, i: int, length: int) -> None:
        """Flip one bit, drawn by the chaos injector's seeded RNG, inside
        the first ``length`` positions of block / row ``i`` of the FIRST
        cache leaf (the reference's), in place under the step lock."""
        from ..chaos import inject as _chaos
        self._check_range("corrupt", i, 0, length)
        lo = int(i) * self._kv_n1
        with self._lock, self.on_stream():
            view = self._kv_bytes[0, lo:lo + int(length)]
            raw = view.cpu().numpy().tobytes()
            flipped = torch.frombuffer(bytearray(_chaos.corrupt_copy(raw)),
                                       dtype=torch.uint8)
            view.copy_(flipped.view(view.shape).to(self.device))

    def corrupt_kv_slot(self, slot: int, length: int) -> None:
        """Flip one deterministically chosen bit inside ``slot``'s valid
        cache prefix — the chaos ``serve.kv`` fault body (slotted). Real
        device bytes change, so detection must come from the crc ledger,
        not from bookkeeping."""
        if self.paged:
            raise RuntimeError("corrupt_kv_slot is slotted-only")
        self._corrupt(slot, length)

    def corrupt_kv_block(self, block: int, length: int) -> None:
        """Paged ``serve.kv`` fault body: flip one bit inside the first
        ``length`` positions of pool block ``block`` — real device bytes,
        caught only by the per-block crc ledger."""
        if not self.paged:
            raise RuntimeError("corrupt_kv_block is paged-only")
        self._corrupt(block, length)

    # -- hot weight swap -----------------------------------------------------
    def swap_params(self, new_state: Mapping[str, Any], *,
                    version: Optional[int] = None) -> bool:
        """Adopt ``new_state`` (a state dict in the port's names, e.g.
        ``models.convert.llama_from_flax`` of the reference's params)
        between steps.

        The version fence: a ``version`` at or below ``params_version``
        is refused (returns False), checked again under the lock, so
        out-of-order publications never roll weights back. Keys, shapes
        and dtypes must equal the serving parameters', else
        ``ValueError``: a dtype change is cast by the publisher, not
        here. The new weights are staged on the device outside the lock
        and copied into the live parameters under it, so every captured
        graph replays them and no graph is added. Returns True on
        adoption and observes ``hvd_weight_swap_ms``; ``last_swap`` gets
        the adoption's ms, its staging and its fenced copy apart."""
        t0 = time.perf_counter()
        if version is not None and self.params_version is not None \
                and version <= self.params_version:
            return False
        live = self.model.state_dict(keep_vars=True)
        new = {k: torch.as_tensor(v) for k, v in dict(new_state).items()}
        if set(new) != set(live) or any(
                tuple(new[k].shape) != tuple(t.shape)
                or new[k].dtype != t.dtype for k, t in live.items()):
            raise ValueError(
                "swap_params: the replacement state does not match the "
                "serving parameters (key / shape / dtype mismatch): "
                "refusing a structurally torn swap (cast to the serving "
                "dtype before publishing)")
        staged = self._stage(new)
        t_staged = time.perf_counter()
        with self._lock, self.on_stream():
            # re-check under the lock: another thread may have adopted a
            # newer version while this one staged
            if version is not None and self.params_version is not None \
                    and version <= self.params_version:
                return False
            t_fence = time.perf_counter()
            with torch.no_grad():
                for k, t in live.items():
                    t.copy_(staged[k])
            if self.stream is not None:
                self.stream.synchronize()
            self.params_version = version if version is not None else \
                (self.params_version or 0) + 1
            self.swaps += 1
            t_done = time.perf_counter()
        dt_ms = (t_done - t0) * 1000.0
        self.last_swap = {"version": self.params_version, "ms": dt_ms,
                          "stage_ms": (t_staged - t0) * 1000.0,
                          "fence_ms": (t_done - t_fence) * 1000.0}
        self._m_swap_ms.observe(dt_ms)
        logger.info("serve executor (role=%s): weights version %s adopted "
                    "in %.1f ms", self.role, self.params_version, dt_ms)
        return True

    def _stage(self, new: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The new weights on the executor's device (a card: copied on a
        stream of their own, finished before return)."""
        if self.device.type != "cuda":
            return {k: v.to(self.device) for k, v in new.items()}
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            staged = {k: v.to(self.device) for k, v in new.items()}
        stream.synchronize()
        return staged

    # -- metrics -------------------------------------------------------------
    def tokens_per_s(self) -> float:
        """Rolling throughput over the retained step window."""
        if len(self._tok_window) < 2:
            return 0.0
        t_first = self._tok_window[0][0]
        t_last = self._tok_window[-1][0]
        if t_last <= t_first:
            return 0.0
        toks = sum(n for _, n in self._tok_window) - self._tok_window[0][1]
        return toks / (t_last - t_first)

    def p50_step_ms(self, kind: str = "decode") -> Optional[float]:
        lat = self.step_latencies_ms[kind]
        return float(np.median(lat)) if lat else None
