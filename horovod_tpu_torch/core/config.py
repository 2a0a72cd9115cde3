"""Runtime knobs of the port, with the reference's HOROVOD_* names.

A copy of the subset of ``horovod_tpu/core/config.py`` that the ported
paths read: the same environment names, parsing and range validation.
The serve knobs parse strictly (a malformed value raises instead of
silently falling back to the default); ``HOROVOD_FUSION_THRESHOLD``
keeps the reference's lenient legacy parse (a malformed or negative
value leaves the 64 MB default). ``HOROVOD_SERVE_KERNEL`` names the
port's kernels: ``auto | cuda | reference``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

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

    @staticmethod
    def from_env() -> "Config":
        c = Config()
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
        if self.serve_kernel not in KERNEL_CHOICES:
            raise ValueError(
                f"HOROVOD_SERVE_KERNEL must be 'auto', 'cuda' or "
                f"'reference' (the paged attention kernel, resolved once "
                f"at executor build); got {self.serve_kernel!r}")
