"""Runtime knobs of the port, with the reference's HOROVOD_* names.

A copy of the subset of ``horovod_tpu/core/config.py`` that the ported
paths read: the same environment names, parsing and range validation.
The serve knobs parse strictly (a malformed value raises instead of
silently falling back to the default); ``HOROVOD_FUSION_THRESHOLD``
keeps the reference's lenient legacy parse (a malformed or negative
value leaves the 64 MB default). ``HOROVOD_SERVE_KERNEL`` names the
port's kernels: ``auto | cuda | reference``. ``HOROVOD_CHAOS_PLAN`` is
parsed in full at validation (``chaos/plan.py``), as the reference does.
``HOROVOD_GLOO_TIMEOUT_SECONDS`` keeps the reference's lenient parse; the
retry ladder's ``HOROVOD_NET_*`` knobs (``native/resilience.py``), the
serve wire's frame ceiling and the checkpoint plane's ``HOROVOD_CKPT_*``
knobs parse strictly (the two booleans as the reference parses them).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

KERNEL_CHOICES = ("auto", "cuda", "reference")


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_float(name: str, default: float) -> float:
    """Lenient parse: a malformed value falls back to ``default`` (the
    reference's contract for its legacy knobs)."""
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _env_int_strict(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer; got {v!r}")


def _env_float_strict(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a number; got {v!r}")


@dataclass
class Config:
    """The knobs the ported paths read."""
    # collective stall bound, seconds (HOROVOD_GLOO_TIMEOUT_SECONDS): the
    # retry budget below must stay under it
    gloo_timeout_seconds: float = 300.0
    # fusion buffer: grouped allreduces pack same-dtype tensors into
    # buckets of at most this many bytes (HOROVOD_FUSION_THRESHOLD;
    # 0 disables fusion)
    fusion_threshold_bytes: int = 64 * 1024 * 1024
    # fixed decode batch shape (HOROVOD_SERVE_MAX_BATCH)
    serve_max_batch: int = 8
    # admission-queue bound past which submits are load-shed
    serve_max_queue: int = 64
    # default per-request deadline in milliseconds
    serve_deadline_ms: float = 30000.0
    # prefill length buckets (csv): one program shape per bucket
    serve_buckets: tuple = (32, 128, 512)
    # paged KV block size in tokens; the port is paged-only, so 0 means
    # "let the caller's model config decide"
    serve_kv_block: int = 0
    # radix prefix cache over prompt token ids
    serve_prefix_cache: bool = True
    # paged attention kernel: "cuda" (the hand-written kernel),
    # "reference" (the plain PyTorch version) or "auto" (cuda on a CUDA
    # device, reference on the CPU); resolved once at executor build
    serve_kernel: str = "auto"
    # speculative decoding draft depth: with a draft executor attached,
    # the drafter proposes up to this many tokens per iteration and the
    # target verifies them in one [max_batch, spec_k + 1] step; 0 turns
    # speculation off even when a drafter is given
    serve_spec_k: int = 3
    # per-slot / per-block KV integrity: crc-on-write and verify-on-read
    # of every retiring sequence's cache prefix (one batched device read
    # a step, one a retiring request); off by default
    serve_kv_crc: bool = False
    # the KV tier: evicted refcount-zero prefix runs demote HBM -> host
    # RAM -> disk and promote back through the crc-gated, version-fenced
    # install path; paged + prefix cache only; off by default
    serve_kvtier: bool = False
    # host-RAM ring bound for demoted KV blocks, MiB per replica
    serve_kvtier_host_mb: int = 64
    # disk spill directory of the KV tier ("" disables the disk rung)
    serve_kvtier_dir: str = ""
    # serve wire frame ceiling in bytes (HOROVOD_SERVE_WIRE_MAX_FRAME):
    # the largest frame serve/wire.py sends or accepts (KV pull and
    # migration payloads scale with the model and the context)
    serve_wire_max_frame: int = 4 * 1024 * 1024
    # the retry ladder (native/resilience.py): retries a wire request
    # survives (HOROVOD_NET_RETRIES; 0 disables the ladder), the first
    # backoff delay in ms (HOROVOD_NET_BACKOFF_BASE_MS), and the total
    # retry budget per request in seconds (HOROVOD_NET_RETRY_BUDGET_S;
    # below the collective timeout; unset, min(10, timeout / 2))
    net_retries: int = 4
    net_backoff_base_ms: float = 25.0
    net_retry_budget_s: float = 10.0
    # chaos plan (inline JSON or a file path); None disarms
    chaos_plan: Optional[str] = None
    # distributed request tracing over the process fleet (HOROVOD_TRACE):
    # 1 arms the router's TraceAssembler; workers record for any request
    # carrying a context and need no knob
    trace: bool = False
    # head-sample rate in [0, 1] (HOROVOD_TRACE_SAMPLE): the share of
    # traces retained in full even when nothing interesting happened
    trace_sample: float = 0.0
    # spans buffered per process by the trace recorder
    trace_ring: int = 4096
    # tail-sampled traces the router keeps (HOROVOD_TRACE_RETAIN)
    trace_retain: int = 256
    # e2e ms at or above which a trace counts as slow and is retained
    # (HOROVOD_TRACE_SLOW_MS)
    trace_slow_ms: float = 2000.0
    # the checkpoint plane (ckpt/): in-flight async host snapshots, each
    # a full tree copy; save() blocks beyond it
    # (HOROVOD_CKPT_SNAPSHOT_DEPTH; 2 = double buffering)
    ckpt_snapshot_depth: int = 2
    # buddy-rank shard mirroring over the p2p ring, so one lost host's
    # shard reads back from its ring successor (HOROVOD_CKPT_REPLICATE)
    ckpt_replicate: bool = False
    # committed checkpoints kept per directory; 0 keeps every one
    # (HOROVOD_CKPT_MAX_TO_KEEP)
    ckpt_max_to_keep: int = 3
    # restore the last commit on an elastic (re)entry
    # (HOROVOD_CKPT_AUTO_RESTORE); read here, acted on by the elastic
    # slice
    ckpt_auto_restore: bool = False

    @staticmethod
    def from_env() -> "Config":
        c = Config()
        c.gloo_timeout_seconds = _env_float(
            "HOROVOD_GLOO_TIMEOUT_SECONDS", c.gloo_timeout_seconds)
        mb = _env_float("HOROVOD_FUSION_THRESHOLD", -1.0)
        if mb >= 0:
            c.fusion_threshold_bytes = int(mb)
        c.serve_max_batch = _env_int_strict(
            "HOROVOD_SERVE_MAX_BATCH", c.serve_max_batch)
        c.serve_max_queue = _env_int_strict(
            "HOROVOD_SERVE_MAX_QUEUE", c.serve_max_queue)
        c.serve_deadline_ms = _env_float_strict(
            "HOROVOD_SERVE_DEADLINE_MS", c.serve_deadline_ms)
        raw_buckets = os.environ.get("HOROVOD_SERVE_BUCKETS")
        if raw_buckets is not None:
            try:
                c.serve_buckets = tuple(
                    int(x) for x in raw_buckets.split(",") if x.strip())
            except ValueError:
                raise ValueError(
                    f"HOROVOD_SERVE_BUCKETS must be a comma-separated "
                    f"list of ints; got {raw_buckets!r}")
        c.serve_kv_block = _env_int_strict(
            "HOROVOD_SERVE_KV_BLOCK", c.serve_kv_block)
        c.serve_prefix_cache = _env_bool(
            "HOROVOD_SERVE_PREFIX_CACHE", c.serve_prefix_cache)
        c.serve_spec_k = _env_int_strict(
            "HOROVOD_SERVE_SPEC_K", c.serve_spec_k)
        raw = os.environ.get("HOROVOD_SERVE_KERNEL")
        if raw is not None:
            c.serve_kernel = raw.strip().lower()
        c.serve_kv_crc = _env_bool("HOROVOD_SERVE_KV_CRC", c.serve_kv_crc)
        c.serve_kvtier = _env_bool("HOROVOD_SERVE_KVTIER", c.serve_kvtier)
        c.serve_kvtier_host_mb = _env_int_strict(
            "HOROVOD_SERVE_KVTIER_HOST_MB", c.serve_kvtier_host_mb)
        raw = os.environ.get("HOROVOD_SERVE_KVTIER_DIR")
        if raw is not None:
            c.serve_kvtier_dir = raw.strip()
        c.serve_wire_max_frame = _env_int_strict(
            "HOROVOD_SERVE_WIRE_MAX_FRAME", c.serve_wire_max_frame)
        c.net_retries = _env_int_strict("HOROVOD_NET_RETRIES", c.net_retries)
        c.net_backoff_base_ms = _env_float_strict(
            "HOROVOD_NET_BACKOFF_BASE_MS", c.net_backoff_base_ms)
        # the unset budget derives from the collective timeout, so that
        # shortening the stall bound never trips the validation below
        from ..native.resilience import default_budget_s
        c.net_retry_budget_s = _env_float_strict(
            "HOROVOD_NET_RETRY_BUDGET_S",
            default_budget_s(c.gloo_timeout_seconds))
        c.chaos_plan = os.environ.get("HOROVOD_CHAOS_PLAN") or None
        c.trace = _env_bool("HOROVOD_TRACE", c.trace)
        c.trace_sample = _env_float_strict(
            "HOROVOD_TRACE_SAMPLE", c.trace_sample)
        c.trace_ring = _env_int_strict("HOROVOD_TRACE_RING", c.trace_ring)
        c.trace_retain = _env_int_strict(
            "HOROVOD_TRACE_RETAIN", c.trace_retain)
        c.trace_slow_ms = _env_float_strict(
            "HOROVOD_TRACE_SLOW_MS", c.trace_slow_ms)
        c.ckpt_snapshot_depth = _env_int_strict(
            "HOROVOD_CKPT_SNAPSHOT_DEPTH", c.ckpt_snapshot_depth)
        c.ckpt_max_to_keep = _env_int_strict(
            "HOROVOD_CKPT_MAX_TO_KEEP", c.ckpt_max_to_keep)
        c.ckpt_replicate = _env_bool(
            "HOROVOD_CKPT_REPLICATE", c.ckpt_replicate)
        c.ckpt_auto_restore = _env_bool(
            "HOROVOD_CKPT_AUTO_RESTORE", c.ckpt_auto_restore)
        c.validate()
        return c

    def validate(self) -> None:
        ft = self.fusion_threshold_bytes
        if not isinstance(ft, int) or ft < 0:
            raise ValueError(
                f"HOROVOD_FUSION_THRESHOLD must be a non-negative byte "
                f"count (0 disables fusion); got {ft!r}")
        if not isinstance(self.serve_max_batch, int) or \
                not (1 <= self.serve_max_batch <= 4096):
            raise ValueError(
                f"HOROVOD_SERVE_MAX_BATCH must be an int in [1, 4096] "
                f"(the fixed decode batch shape); got "
                f"{self.serve_max_batch!r}")
        if not isinstance(self.serve_max_queue, int) or \
                self.serve_max_queue < 1:
            raise ValueError(
                f"HOROVOD_SERVE_MAX_QUEUE must be a positive int; got "
                f"{self.serve_max_queue!r}")
        dl = self.serve_deadline_ms
        if not isinstance(dl, (int, float)) or not (0 < dl <= 86_400_000):
            raise ValueError(
                f"HOROVOD_SERVE_DEADLINE_MS must be milliseconds in "
                f"(0, 86400000]; got {dl!r}")
        kb = self.serve_kv_block
        if not isinstance(kb, int) or not (0 <= kb <= 4096):
            raise ValueError(
                f"HOROVOD_SERVE_KV_BLOCK must be an int in [0, 4096] "
                f"tokens (the block size shapes the device pool); got "
                f"{kb!r}")
        if not isinstance(self.serve_prefix_cache, bool):
            raise ValueError(
                f"HOROVOD_SERVE_PREFIX_CACHE must be a boolean; got "
                f"{self.serve_prefix_cache!r}")
        sk = self.serve_spec_k
        if not isinstance(sk, int) or not (0 <= sk <= 64):
            raise ValueError(
                f"HOROVOD_SERVE_SPEC_K must be an int in [0, 64] (the "
                f"verify step's shape is [max_batch, spec_k+1]); got "
                f"{sk!r}")
        wf = self.serve_wire_max_frame
        if not isinstance(wf, int) or \
                not (1 << 16 <= wf <= (1 << 31) - 1):
            raise ValueError(
                f"HOROVOD_SERVE_WIRE_MAX_FRAME must be bytes in "
                f"[{1 << 16}, {(1 << 31) - 1}] (the serve wire frame "
                f"ceiling; bit 31 of the length word is the binary-"
                f"frame flag, so a full 2 GiB frame cannot be "
                f"represented); got {wf!r}")
        if self.serve_kernel not in KERNEL_CHOICES:
            raise ValueError(
                f"HOROVOD_SERVE_KERNEL must be 'auto', 'cuda' or "
                f"'reference' (the paged attention kernel, resolved once "
                f"at executor build); got {self.serve_kernel!r}")
        if not isinstance(self.serve_kv_crc, bool):
            raise ValueError(
                f"HOROVOD_SERVE_KV_CRC must be a boolean; got "
                f"{self.serve_kv_crc!r}")
        if not isinstance(self.serve_kvtier, bool):
            raise ValueError(
                f"HOROVOD_SERVE_KVTIER must be a boolean; got "
                f"{self.serve_kvtier!r}")
        hm = self.serve_kvtier_host_mb
        if not isinstance(hm, int) or not (0 <= hm <= 1_048_576):
            raise ValueError(
                f"HOROVOD_SERVE_KVTIER_HOST_MB must be MiB in "
                f"[0, 1048576] (the host-RAM ring bound for demoted KV "
                f"blocks; 0 spills every demotion straight to disk or "
                f"drops it); got {hm!r}")
        if not isinstance(self.serve_kvtier_dir, str):
            raise ValueError(
                f"HOROVOD_SERVE_KVTIER_DIR must be a directory path "
                f"string ('' disables the disk tier); got "
                f"{self.serve_kvtier_dir!r}")
        tsr = self.trace_sample
        if not isinstance(tsr, (int, float)) or not (0 <= tsr <= 1):
            raise ValueError(
                f"HOROVOD_TRACE_SAMPLE must be a fraction in [0, 1]; "
                f"got {tsr!r}")
        tring = self.trace_ring
        if not isinstance(tring, int) or not (1 <= tring <= 10_000_000):
            raise ValueError(
                f"HOROVOD_TRACE_RING must be an int in [1, 10000000] "
                f"(total spans buffered per process); got {tring!r}")
        tret = self.trace_retain
        if not isinstance(tret, int) or not (1 <= tret <= 1_000_000):
            raise ValueError(
                f"HOROVOD_TRACE_RETAIN must be an int in [1, 1000000] "
                f"(tail-sampled traces kept); got {tret!r}")
        tslow = self.trace_slow_ms
        if not isinstance(tslow, (int, float)) \
                or not (0 < tslow <= 86_400_000):
            raise ValueError(
                f"HOROVOD_TRACE_SLOW_MS must be milliseconds in "
                f"(0, 86400000]; got {tslow!r}")
        sd = self.ckpt_snapshot_depth
        if not isinstance(sd, int) or not (1 <= sd <= 64):
            raise ValueError(
                f"HOROVOD_CKPT_SNAPSHOT_DEPTH must be an int in [1, 64] "
                f"(in-flight host snapshots, each a full tree copy); "
                f"got {sd!r}")
        mk = self.ckpt_max_to_keep
        if not isinstance(mk, int) or not (0 <= mk <= 1_000_000):
            raise ValueError(
                f"HOROVOD_CKPT_MAX_TO_KEEP must be an int in "
                f"[0, 1000000] (0 keeps every checkpoint); got {mk!r}")
        nr = self.net_retries
        if not isinstance(nr, int) or not (0 <= nr <= 100):
            raise ValueError(
                f"HOROVOD_NET_RETRIES must be an int in [0, 100] "
                f"(0 disables the retry ladder); got {nr!r}")
        nb = self.net_backoff_base_ms
        if not isinstance(nb, (int, float)) or not (0 < nb <= 60_000):
            raise ValueError(
                f"HOROVOD_NET_BACKOFF_BASE_MS must be milliseconds in "
                f"(0, 60000]; got {nb!r}")
        nbd = self.net_retry_budget_s
        if not isinstance(nbd, (int, float)) or not (0 < nbd <= 86_400):
            raise ValueError(
                f"HOROVOD_NET_RETRY_BUDGET_S must be seconds in "
                f"(0, 86400]; got {nbd!r}")
        if nr > 0 and nbd >= self.gloo_timeout_seconds:
            raise ValueError(
                f"HOROVOD_NET_RETRY_BUDGET_S ({nbd!r}) must stay BELOW "
                f"the collective timeout "
                f"HOROVOD_GLOO_TIMEOUT_SECONDS "
                f"({self.gloo_timeout_seconds!r}) — the retry ladder "
                f"may delay an escalation, never mask one")
        if self.chaos_plan is not None:
            # the full fail-fast parse: chaos.plan is stdlib only
            from ..chaos.plan import ChaosPlan, PlanError
            try:
                ChaosPlan.parse(self.chaos_plan)
            except PlanError as e:
                raise ValueError(f"HOROVOD_CHAOS_PLAN invalid: {e}") \
                    from None
        bk = self.serve_buckets
        if (not isinstance(bk, (tuple, list)) or not bk
                or not all(isinstance(b, int) and b > 0 for b in bk)
                or list(bk) != sorted(set(bk))):
            raise ValueError(
                f"HOROVOD_SERVE_BUCKETS must be strictly ascending "
                f"positive ints (one prefill program compiles per "
                f"bucket); got {bk!r}")
