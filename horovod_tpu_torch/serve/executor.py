"""Model executor: the one fixed-shape step of the server.

The port of ``horovod_tpu/serve/executor.py``. Drives a decode-mode
model (models/llama.py or models/gpt.py) at **fixed shapes**: every call
is ``[max_batch, T]`` tokens with per-row positions, an update mask and a
per-row emitting index, where T is 1 (decode), one of the prefill
buckets, or ``spec_k + 1`` (the speculative verify step). Batch
membership is data, not shape, so sequences join and leave between
iterations.

Two cache layouts, chosen by the model config:

* **paged** (``kv_block_size > 0``): every step takes block tables, and
  attention runs through the kernel resolved ONCE at build
  (``HOROVOD_SERVE_KERNEL`` via ``ops.paged.resolve_kernel``: the CUDA
  kernel K1 on a CUDA device, the plain version on the CPU), stamped into
  the model config; a head dim the CUDA kernel does not take is refused
  then. The ``kernel`` label on ``hvd_serve_step_ms`` names it.
* **slotted** (``kv_block_size == 0``): per-row cache rows and the plain
  attention (``kernel="reference"``), as the reference's slotted
  executors run XLA: the speculative drafter's layout.

Token selection runs on the device: temperature / top-p with per-request
seeds, carried as row data (``sample=``), greedy being the
``temperature == 0`` case (an all-greedy batch takes the argmax with no
sort). Only the per-row emitting position's logits are computed
(``logits_idx`` gathers hidden states before the lm_head). A
``role="draft"`` executor also returns the distribution each token was
drawn from, left on the device for the target's verify step, and labels
its metrics ``role="draft"`` so the target's families stay its own. The
verify step (``kind="verify"``) computes every position's logits and
applies the rejection-sampling accept rule
(``ops.paged.speculative_accept``). The KV caches live here, one (k, v)
pair per layer, and are updated in place.

Sharding over a mesh, hot weight swaps and the chaos/migration hooks
are later slices.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..obs import metrics as obs_metrics
from ..ops.paged import (STREAM_DRAFT, STREAM_SAMPLE, check_head_dim,
                         resolve_kernel, sample_with_probs,
                         speculative_accept)

logger = logging.getLogger("horovod_tpu_torch")

#: the step kinds, each with its own latency series
KINDS = ("prefill", "decode", "verify")


class ShardedExecutor:
    """Owns the model, the device KV caches and the one step."""

    def __init__(self, model: Any, *, max_batch: int, max_len: int,
                 device=None, mesh=None, partition_rules=None,
                 role: str = "target"):
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
        #: logits of the most recent step (device tensor): [max_batch, V],
        #: or [max_batch, T, V] after a verify step
        self.last_logits: Optional[torch.Tensor] = None
        # -- metrics --
        self.steps = 0
        self.tokens_out = 0
        #: recent step latencies by kind
        self.step_latencies_ms = {k: deque(maxlen=1024) for k in KINDS}
        self._tok_window: "deque[Tuple[float, int]]" = deque(maxlen=1024)
        #: distinct (kind, T) entry points actually executed
        self.signatures: Set[Tuple[str, int]] = set()
        R = obs_metrics.get_registry()
        rl = {"role": "draft"} if role == "draft" else {}
        if role == "target":
            # only the target claims the families fresh: a drafter is
            # built next to a target and must not clobber its series
            R.unregister("hvd_serve_step_ms")
            R.unregister("hvd_serve_tokens_total")
        self._m_step_ms = {
            k: R.histogram("hvd_serve_step_ms",
                           "executor step latency by kind (ms)",
                           dict(rl, kind=k, kernel=self.kernel))
            for k in KINDS}
        self._m_tokens = R.counter("hvd_serve_tokens_total",
                                   "tokens generated", rl or None)
        logger.info("serve executor: role=%s kernel=%s paged=%s device=%s",
                    role, self.kernel, self.paged, self.device)

    def _dev(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(
            self.device, non_blocking=True)

    def _sample_tensors(self, s: Dict[str, np.ndarray]):
        """The per-row sampling arrays on the device: (temperature, top_p,
        seed, ctr)."""
        return (self._dev(s["temperature"], torch.float32),
                self._dev(s["top_p"], torch.float32),
                self._dev(np.asarray(s["seed"]).astype(np.int64),
                          torch.int64),
                self._dev(s["ctr"], torch.int64))

    # -- the one step --------------------------------------------------------
    def step(self, tokens: np.ndarray, positions: np.ndarray,
             mask: np.ndarray, last_idx: np.ndarray, *,
             kind: str = "decode",
             block_tables: Optional[np.ndarray] = None,
             sample: Optional[Dict[str, np.ndarray]] = None,
             draft_probs: Optional[torch.Tensor] = None,
             n_draft: Optional[np.ndarray] = None):
        """Run one fixed-shape forward step.

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
          from, on the device.
        * ``kind="verify"``: ``(emitted [max_batch, T] int32, n_accept
          [max_batch] int32)``: the accept rule applied against
          ``draft_probs [max_batch, T-1, V]`` (a device tensor) with
          per-row real proposal counts ``n_draft``.
        """
        if kind not in KINDS:
            raise ValueError(f"step kind must be one of {KINDS}; got "
                             f"{kind!r}")
        if self.paged and block_tables is None:
            raise ValueError("a paged executor step needs block_tables")
        t0 = time.perf_counter()
        B, T = self.max_batch, int(tokens.shape[1])
        self.signatures.add((kind, T))
        sampled = sample is not None and bool(
            np.any(np.asarray(sample["temperature"]) > 0))
        probs = None
        with torch.inference_mode():
            kw = ({"block_tables": self._dev(block_tables, torch.int32)}
                  if self.paged else {})
            tok_t = self._dev(tokens, torch.int32)
            args = (self._sample_tensors(sample) if sampled
                    else (None,) * 4)
            if kind == "verify":
                logits = self.model(
                    tok_t, self._dev(positions, torch.int32),
                    self._dev(mask, torch.bool), cache=self.cache, **kw)
                self.last_logits = logits
                if sampled and draft_probs is None:
                    draft_probs = torch.zeros(B, T - 1, self.vocab_size,
                                              device=self.device)
                nd = self._dev(np.zeros(B, np.int32) if n_draft is None
                               else n_draft, torch.int64)
                emitted, n_acc = speculative_accept(
                    tok_t, draft_probs, logits, nd, *args, sampled=sampled)
                # the host readback doubles as the step's completion fence
                out = (emitted.cpu().numpy(), n_acc.cpu().numpy())
            else:
                logits = self.model(
                    tok_t, self._dev(positions, torch.int32),
                    self._dev(mask, torch.bool), cache=self.cache,
                    logits_idx=self._dev(last_idx, torch.int64), **kw)
                self.last_logits = logits[:, 0]
                nxt, probs = sample_with_probs(
                    self.last_logits, *args,
                    stream=STREAM_DRAFT if self.role == "draft"
                    else STREAM_SAMPLE, sampled=sampled)
                out = nxt.cpu().numpy()
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.steps += 1
        self.step_latencies_ms[kind].append(dt_ms)
        self._m_step_ms[kind].observe(dt_ms)
        n_tok = int(np.sum(mask))
        self.tokens_out += n_tok
        self._m_tokens.inc(n_tok)
        self._tok_window.append((time.perf_counter(), n_tok))
        if self.role == "draft" and kind != "verify":
            # the proposal distribution stays on the device: the batcher
            # hands it straight to the target's verify step
            return out, probs
        return out

    def copy_kv_block(self, src: int, dst: int) -> None:
        """Device-side copy of pool block ``src`` onto ``dst`` in every
        layer's pools — the copy-on-write body behind partial prefix
        block sharing (serve/prefix.py). Paged executors only."""
        if not self.paged:
            raise ValueError("copy_kv_block needs a paged executor")
        with torch.inference_mode():
            for pool_k, pool_v in self.cache:
                pool_k[dst].copy_(pool_k[src])
                pool_v[dst].copy_(pool_v[src])

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
