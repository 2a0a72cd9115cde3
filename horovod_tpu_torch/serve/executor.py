"""Model executor: the one fixed-shape step of the server.

The port of ``horovod_tpu/serve/executor.py``, paged only. Drives a
decode-mode model (models/llama.py or models/gpt.py) at **fixed
shapes**: every call is ``[max_batch, T]`` tokens with per-row positions,
an update mask, a per-row emitting index and block tables, where T is 1
(decode) or one of the prefill buckets. Batch membership is data, not
shape, so sequences join and leave between iterations.

The attention kernel is resolved ONCE at build
(``HOROVOD_SERVE_KERNEL`` via ``ops.paged.resolve_kernel``: the CUDA
kernel on a CUDA device, the plain version on the CPU) and stamped into
the model config; a head dim the CUDA kernel is not built for is refused
then; the ``kernel`` label on ``hvd_serve_step_ms`` names it.
Only the per-row emitting position's logits are computed (``logits_idx``
gathers hidden states before the lm_head) and the greedy token is the
argmax. The KV pools live here, one (k, v) pair per layer, and are
updated in place.

Sharding over a mesh, draft executors, the speculative verify step, hot
weight swaps and the chaos/migration hooks are later slices.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any, Optional, Set, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..obs import metrics as obs_metrics
from ..ops.paged import check_head_dim, resolve_kernel, sample_greedy

logger = logging.getLogger("horovod_tpu_torch")


class ShardedExecutor:
    """Owns the model, the device KV pools and the one step."""

    def __init__(self, model: Any, *, max_batch: int, max_len: int,
                 device=None, mesh=None, partition_rules=None,
                 role: str = "target"):
        if mesh is not None or partition_rules is not None:
            raise NotImplementedError(
                "mesh/partition_rules: sharded serving is not ported yet")
        if role != "target":
            raise NotImplementedError(
                f"role={role!r}: draft executors (speculative decoding) "
                f"are not ported yet")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        cfg = model.cfg
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"max_len {max_len} exceeds the model's max_seq_len "
                f"{cfg.max_seq_len}")
        self.device = resolve_device(device)
        self.kernel = resolve_kernel(cfg.decode_kernel, device=self.device)
        if self.kernel == "cuda":
            # refuse here, not at the first serve step
            check_head_dim(cfg.head_dim)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_block_size = int(cfg.kv_block_size or 0)
        self.kv_pool_blocks = int(cfg.kv_pool_blocks or 0)
        if self.kv_block_size <= 0:
            raise ValueError("the port's executor is paged only: the "
                             "model config needs kv_block_size > 0")
        #: fixed block-table width: enough entries to address max_len
        self.blocks_per_seq = -(-max_len // self.kv_block_size)
        if self.kv_pool_blocks < self.blocks_per_seq:
            raise ValueError(
                f"kv_pool_blocks {self.kv_pool_blocks} cannot cover one "
                f"max_len sequence ({self.blocks_per_seq} blocks of "
                f"{self.kv_block_size})")
        cfg.decode_kernel = self.kernel
        self.cache = self.model.new_cache()
        #: logits [max_batch, V] of the most recent step (device tensor)
        self.last_logits: Optional[torch.Tensor] = None
        # -- metrics --
        self.steps = 0
        self.tokens_out = 0
        #: recent step latencies by kind ("prefill" / "decode")
        self.step_latencies_ms = {k: deque(maxlen=1024)
                                  for k in ("prefill", "decode")}
        self._tok_window: "deque[Tuple[float, int]]" = deque(maxlen=1024)
        #: distinct (kind, T) entry points actually executed
        self.signatures: Set[Tuple[str, int]] = set()
        R = obs_metrics.get_registry()
        R.unregister("hvd_serve_step_ms")
        R.unregister("hvd_serve_tokens_total")
        self._m_step_ms = {
            k: R.histogram("hvd_serve_step_ms",
                           "executor step latency by kind (ms)",
                           {"kind": k, "kernel": self.kernel})
            for k in ("prefill", "decode")}
        self._m_tokens = R.counter("hvd_serve_tokens_total",
                                   "tokens generated")
        logger.info("serve executor: kernel=%s device=%s", self.kernel,
                    self.device)

    def _dev(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(
            self.device, non_blocking=True)

    # -- the one step --------------------------------------------------------
    def step(self, tokens: np.ndarray, positions: np.ndarray,
             mask: np.ndarray, last_idx: np.ndarray, *,
             kind: str = "decode",
             block_tables: Optional[np.ndarray] = None) -> np.ndarray:
        """Run one fixed-shape forward step and return the greedy next
        token per row, ``[max_batch]`` int32 (valid where ``mask``).

        tokens [max_batch, T] int32; positions/last_idx [max_batch];
        mask [max_batch] bool; block_tables [max_batch, blocks_per_seq]
        int32."""
        if kind not in ("prefill", "decode"):
            raise NotImplementedError(
                f"step kind {kind!r}: the speculative verify step is not "
                f"ported yet")
        if block_tables is None:
            raise ValueError("a paged executor step needs block_tables")
        t0 = time.perf_counter()
        self.signatures.add((kind, int(tokens.shape[1])))
        with torch.inference_mode():
            logits = self.model(
                self._dev(tokens, torch.int32),
                self._dev(positions, torch.int32),
                self._dev(mask, torch.bool),
                self._dev(block_tables, torch.int32), self.cache,
                logits_idx=self._dev(last_idx, torch.int64))
            self.last_logits = logits[:, 0]
            # the host readback doubles as the step's completion fence
            nxt = sample_greedy(self.last_logits).cpu().numpy()
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.steps += 1
        self.step_latencies_ms[kind].append(dt_ms)
        self._m_step_ms[kind].observe(dt_ms)
        n_tok = int(np.sum(mask))
        self.tokens_out += n_tok
        self._m_tokens.inc(n_tok)
        self._tok_window.append((time.perf_counter(), n_tok))
        return nxt

    def copy_kv_block(self, src: int, dst: int) -> None:
        """Device-side copy of pool block ``src`` onto ``dst`` in every
        layer's pools — the copy-on-write body behind partial prefix
        block sharing (serve/prefix.py)."""
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
