"""Transient-fault absorption for the wire planes.

The port's copy of ``horovod_tpu/native/resilience.py``, stdlib only:

* :class:`RetryPolicy` — a seeded-jitter exponential-backoff ladder whose
  delay sequence is deterministic per (seed, rank), byte-identical to
  the reference's for the same arguments. Knobs (strict-parsed in
  ``core/config.py``): ``HOROVOD_NET_RETRIES`` (default 4; 0 disables
  the ladder), ``HOROVOD_NET_BACKOFF_BASE_MS`` (default 25) and
  ``HOROVOD_NET_RETRY_BUDGET_S`` (default 10, clamped to half the
  collective timeout when unset: :func:`default_budget_s`; validated
  below ``HOROVOD_GLOO_TIMEOUT_SECONDS``).
* :func:`is_retryable` — the retryable-vs-fatal classifier: connection
  faults (anything marked :class:`Retryable`, carrying
  ``retryable=True``, or a reset / refused / aborted / broken-pipe
  ``OSError``) retry; timeouts, protocol errors and everything else stay
  fatal.
* the suspect short-circuit: a peer the failure detector
  (``chaos/detector.current_suspects``) already names is not retried.

Metrics ``hvd_net_retries_total{site,outcome}``,
``hvd_net_reconnects_total{plane}`` and ``hvd_net_backoff_ms`` are
reached lazily, so the module stays stdlib-only at import time.
"""
from __future__ import annotations

import logging
import random
import socket
import threading
import time
from typing import Callable, List, Optional

logger = logging.getLogger("horovod_tpu_torch")

#: metric help strings, single-sourced (shared with docs/tests)
RETRIES_HELP = ("transient network faults crossed by the retry ladder, "
                "by site and outcome (absorbed|exhausted|short_circuit)")
RECONNECTS_HELP = ("wire-plane reconnects performed by the retry ladder, "
                   "by plane (store|coord|p2p)")
BACKOFF_HELP = "backoff sleeps taken by the retry ladder (ms)"

DEFAULT_RETRIES = 4
DEFAULT_BACKOFF_BASE_MS = 25.0
DEFAULT_BUDGET_S = 10.0


def default_budget_s(gloo_timeout_s: float) -> float:
    """The derived default retry budget when HOROVOD_NET_RETRY_BUDGET_S
    is unset: 10 s, clamped to HALF the collective timeout. A
    deployment that shortens the stall bound (failure-mode tests run at
    2 s) must not trip the budget-below-timeout validation on a knob it
    never set; an EXPLICIT budget at or past the timeout still
    fails fast (core/config.py validate)."""
    return min(DEFAULT_BUDGET_S, float(gloo_timeout_s) / 2.0)


class Retryable:
    """Marker mixin: exceptions inheriting this are connection-class
    transient faults the ladder may absorb. ``NativeConnError`` and
    ``P2PConnError`` are the in-tree members."""


#: OSError subclasses that are connection faults even without the
#: marker (raw socket paths). socket.timeout is deliberately absent:
#: a timeout means the configured stall bound already elapsed.
_CONN_OSERRORS = (ConnectionResetError, ConnectionRefusedError,
                  ConnectionAbortedError, BrokenPipeError)


def is_retryable(exc: BaseException) -> bool:
    """The retryable-vs-fatal classifier every wire boundary consults.

    Retryable: :class:`Retryable` subclasses, exceptions carrying an
    explicit ``retryable=True`` attribute (RedistError wrapping), and
    bare connection-class OSErrors. Fatal: timeouts (NativeTimeout,
    socket.timeout — the stall bound already elapsed; retrying would
    mask a real death), protocol errors, and everything else.
    """
    if isinstance(exc, Retryable):
        return True
    marked = getattr(exc, "retryable", None)
    if marked is not None:
        return bool(marked)
    if isinstance(exc, socket.timeout):
        return False
    if isinstance(exc, _CONN_OSERRORS):
        return True
    return False


def suspected(peer: Optional[int]) -> bool:
    """Is ``peer`` already named by the running failure detector? The
    ladder short-circuits then — the detector's verdict outranks hope."""
    if peer is None:
        return False
    try:
        from ..chaos.detector import current_suspects
        return peer in current_suspects()
    except Exception:  # noqa: BLE001 — the observer must not break I/O
        return False


# -- observability (lazy; the chaos/inject.py pattern) -----------------------

def _registry():
    try:
        from ..obs import metrics as obs_metrics
        return obs_metrics.get_registry()
    except Exception:  # noqa: BLE001
        return None


def observe_reconnect(plane: str) -> None:
    """Count one reconnect of ``plane`` (store|coord|p2p). Called by
    the planes' reconnect hooks so every re-dial is visible even when
    it happens outside a ladder."""
    reg = _registry()
    if reg is not None:
        try:
            reg.counter("hvd_net_reconnects_total", RECONNECTS_HELP,
                        {"plane": plane}).inc()
        except Exception:  # noqa: BLE001
            pass


def count_retry(site: str, outcome: str, n: int = 1) -> None:
    reg = _registry()
    if reg is not None:
        try:
            reg.counter("hvd_net_retries_total", RETRIES_HELP,
                        {"site": site, "outcome": outcome}).inc(n)
        except Exception:  # noqa: BLE001
            pass


def observe_backoff(delay_s: float) -> None:
    reg = _registry()
    if reg is not None:
        try:
            reg.histogram("hvd_net_backoff_ms",
                          BACKOFF_HELP).observe(delay_s * 1000.0)
        except Exception:  # noqa: BLE001
            pass


def timeline_net(payload: dict) -> None:
    try:
        from ..chaos.inject import _live_timeline
        tl = _live_timeline()
        if tl is not None:
            tl.instant("NET", payload)
    except Exception:  # noqa: BLE001
        pass


class RetryPolicy:
    """A deterministic backoff ladder: ``retries`` attempts after the
    first, delay k = ``base_ms * 2**k`` with seeded jitter in
    [1.0, 1.5), every delay and their SUM capped by ``budget_s``.

    The sequence is precomputed at construction from
    ``random.Random(f"{seed}:{rank}")`` — byte-identical per
    (seed, rank), asserted by the tests — so retry timing
    never perturbs a seeded soak's reproducibility.
    """

    def __init__(self, retries: int = DEFAULT_RETRIES,
                 backoff_base_ms: float = DEFAULT_BACKOFF_BASE_MS,
                 budget_s: float = DEFAULT_BUDGET_S, *,
                 seed: int = 0, rank: int = 0):
        if retries < 0:
            raise ValueError(f"retries must be >= 0; got {retries}")
        if backoff_base_ms <= 0:
            raise ValueError(
                f"backoff_base_ms must be positive; got {backoff_base_ms}")
        if budget_s <= 0:
            raise ValueError(f"budget_s must be positive; got {budget_s}")
        self.retries = int(retries)
        self.backoff_base_ms = float(backoff_base_ms)
        self.budget_s = float(budget_s)
        self.seed, self.rank = int(seed), int(rank)
        rng = random.Random(f"{seed}:{rank}")
        delays: List[float] = []
        total = 0.0
        for k in range(self.retries):
            d = (self.backoff_base_ms / 1000.0) * (2 ** k) \
                * (1.0 + rng.random() * 0.5)
            d = min(d, max(self.budget_s - total, 0.0))
            delays.append(d)
            total += d
        self._delays = tuple(delays)

    @property
    def delays(self) -> tuple:
        """The full backoff sequence (seconds); sum <= budget_s."""
        return self._delays

    def run(self, fn: Callable, *, what: str, site: str, plane: str,
            reconnect: Optional[Callable[[], None]] = None,
            peer: Optional[int] = None,
            abort: Optional[Callable[[], bool]] = None):
        """Execute ``fn`` under the ladder.

        Retryable failures (per :func:`is_retryable`) are absorbed:
        sleep the next backoff delay, call ``reconnect`` (best-effort —
        a failed re-dial just burns the attempt), re-run. Fatal
        failures, ladder exhaustion, budget exhaustion, and peers the
        failure detector already suspects all re-raise the ORIGINAL
        exception so callers' classification is unchanged.

        ``abort`` (optional) is the caller-local short-circuit twin of
        the suspect check: consulted before every retry, and when it
        returns True the ladder stops hoping and re-raises immediately
        (counted ``short_circuit``). The serve fleet's dispatch path
        passes "has this request already failed over / this replica
        already been ejected?" here — its replicas are not peers the
        global failure detector monitors, but retrying a request the
        router already re-dispatched elsewhere would be the same futile
        theater the suspect rule exists to prevent.
        """
        if self.retries == 0:
            return fn()
        t0 = time.monotonic()
        absorbed = 0
        attempt = 0
        while True:
            try:
                out = fn()
                if absorbed:
                    count_retry(site, "absorbed", absorbed)
                    logger.info(
                        "NET: %s absorbed %d transient fault(s) at %s "
                        "(%.0f ms)", what, absorbed, site,
                        (time.monotonic() - t0) * 1000.0)
                return out
            except Exception as e:  # noqa: BLE001 — classified below
                if not is_retryable(e):
                    raise
                if attempt >= self.retries:
                    count_retry(site, "exhausted")
                    logger.warning(
                        "NET: %s exhausted %d retries at %s: %s", what,
                        self.retries, site, e)
                    raise
                delay = self._delays[attempt]
                if time.monotonic() - t0 + delay > self.budget_s:
                    count_retry(site, "exhausted")
                    logger.warning(
                        "NET: %s exhausted the %.1fs retry budget at "
                        "%s: %s", what, self.budget_s, site, e)
                    raise
                if suspected(peer):
                    count_retry(site, "short_circuit")
                    logger.warning(
                        "NET: %s NOT retried — failure detector already "
                        "suspects peer %s: %s", what, peer, e)
                    raise
                if abort is not None and abort():
                    count_retry(site, "short_circuit")
                    logger.warning(
                        "NET: %s NOT retried — caller aborted the "
                        "ladder: %s", what, e)
                    raise
                attempt += 1
                absorbed += 1
                observe_backoff(delay)
                timeline_net({"site": site, "what": what,
                               "attempt": attempt,
                               "backoff_ms": round(delay * 1000.0, 2),
                               "error": str(e)[:160]})
                logger.info(
                    "NET: transient fault at %s (%s) — retry %d/%d in "
                    "%.0f ms: %s", site, what, attempt, self.retries,
                    delay * 1000.0, e)
                time.sleep(delay)
                if reconnect is not None:
                    try:
                        reconnect()
                    except Exception:  # noqa: BLE001 — a failed re-dial
                        pass           # just burns this attempt


# -- process policy ----------------------------------------------------------

_LOCK = threading.Lock()
_POLICY: Optional[RetryPolicy] = None


def policy() -> RetryPolicy:
    """The process-wide policy, built once from the HOROVOD_NET_* env
    (strict parsing — core/config.py validates the same values with
    the budget-below-collective-timeout bound at init)."""
    global _POLICY
    with _LOCK:
        if _POLICY is None:
            from ..core.config import (_env_float, _env_float_strict,
                                       _env_int_strict)
            import os
            rank = int(os.environ.get("HOROVOD_RANK", "0") or 0)
            # knob: exempt (stdlib-only fallback mirroring the Config
            # defaults — core/config.py imports THIS module for
            # default_budget_s, so reading Config here would cycle)
            gloo = _env_float("HOROVOD_GLOO_TIMEOUT_SECONDS", 300.0)
            _POLICY = RetryPolicy(
                retries=_env_int_strict(  # knob: exempt (see gloo above)
                    "HOROVOD_NET_RETRIES", DEFAULT_RETRIES),
                backoff_base_ms=_env_float_strict(  # knob: exempt (see above)
                    "HOROVOD_NET_BACKOFF_BASE_MS",
                    DEFAULT_BACKOFF_BASE_MS),
                budget_s=_env_float_strict(  # knob: exempt (see above)
                    "HOROVOD_NET_RETRY_BUDGET_S",
                    default_budget_s(gloo)),
                rank=rank)
        return _POLICY


def reset_policy() -> None:
    """Drop the cached policy so the next use re-reads the env (tests;
    elastic relaunches start a fresh process anyway)."""
    global _POLICY
    with _LOCK:
        _POLICY = None
