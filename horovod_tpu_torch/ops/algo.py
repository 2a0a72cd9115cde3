"""Collective algorithm selection (the algorithm plane), the port's copy.

A copy of ``horovod_tpu/ops/algo.py``, which is pure math and imports
nothing of JAX: the registry of allreduce strategies, the alpha-beta
cost model and :func:`resolve`. The port's data plane runs them over
``torch.distributed`` (``ops/collective_ops.py``, ``ops/cross.py``):

  ========== =========================================================
  direct     one ``all_reduce``
  rs_ag      ``reduce_scatter_tensor`` + ``all_gather_into_tensor``
  rhd        recursive halving / doubling over ``isend`` / ``irecv``,
             power-of-two sets only
  two_level  local reduce-scatter / cross allreduce / local allgather
             over the local and cross groups of ``HOROVOD_LOCAL_SIZE``
  ========== =========================================================

The link constants are the reference's; on GPUs they only order the
strategies (``resolve`` with ``auto``), which every rank computes from
the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import log2
from typing import Optional, Tuple

#: allreduce strategy registry, in deterministic tie-break order
ALGORITHMS = ("direct", "rs_ag", "rhd", "two_level")

#: values HOROVOD_COLLECTIVE_ALGO accepts
ALGO_CHOICES = ("auto",) + ALGORITHMS


@dataclass(frozen=True)
class LinkModel:
    """Alpha-beta-gamma link cost: per-hop latency `alpha_s`, inverse
    bandwidth `beta_s_per_byte`, and per-HLO dispatch cost `launch_s`
    (the gamma term that separates one-program `direct` from multi-phase
    schedules at tiny sizes)."""

    alpha_s: float
    beta_s_per_byte: float
    launch_s: float


#: ICI defaults: ~1 us/hop, ~100 GB/s per link (TPU v4/v5 class)
ICI = LinkModel(alpha_s=1e-6, beta_s_per_byte=1.0 / 100e9, launch_s=2e-6)
#: DCN defaults: ~50 us/hop, ~12.5 GB/s (100 Gb NIC class)
DCN = LinkModel(alpha_s=50e-6, beta_s_per_byte=1.0 / 12.5e9, launch_s=2e-6)

#: rhd's byte-term handicap: halving/doubling exchanges non-contiguous
#: halves with distance-2^k partners, which on ring/torus links means
#: multi-hop routing contention the per-neighbor ring never pays — the
#: classic reason MPI/NCCL switch to ring schedules for large payloads
#: (Thakur et al.; both PAPERS.md allreduce surveys). Without it the
#: model would (wrongly) pick rhd at every size on power-of-two worlds.
RHD_BW_PENALTY = 1.5

#: below this the MODEL always answers "direct": sub-KB payloads
#: (barrier tokens, control-plane probes) are launch-overhead-dominated
#: — no schedule beats one fused HLO, and churning compiled variants
#: for them costs real compile time for zero wire savings. The tuner's
#: learned per-regime choices and explicit overrides are NOT floored:
#: a measured preference always stands.
MIN_MODEL_BYTES = 1024


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def predict_cost(algo: str, nbytes: int, world: int, *,
                 hier_shape: Optional[Tuple[int, int]] = None,
                 dcn: bool = False,
                 ici: LinkModel = ICI, dcn_link: LinkModel = DCN) -> float:
    """Predicted seconds for one allreduce of `nbytes` per rank.

    `dcn=True` models a mesh whose flat ring crosses DCN links (the
    multi-host regime): flat algorithms then pay DCN alpha/beta on every
    hop, which is exactly what makes `two_level` attractive — its cross
    phase moves nbytes/local_size.
    """
    if world <= 1:
        return 0.0
    link = dcn_link if dcn else ici
    P = world
    N = float(max(nbytes, 0))
    ring_bw = 2.0 * N * (P - 1) / P * link.beta_s_per_byte
    if algo == "direct":
        return link.launch_s + 2 * (P - 1) * link.alpha_s + ring_bw
    if algo == "rs_ag":
        # modelled as direct + one extra launch: in the alpha-beta
        # abstraction both are bandwidth-optimal rings, so the ANALYTIC
        # selector never picks rs_ag — deliberately. Where the explicit
        # decomposition beats the fused psum (scheduling/memory effects
        # the link model cannot see; bench.py --collectives measures it
        # winning the large regime on the CPU mesh), the AUTOTUNER's
        # per-regime dims are the mechanism that finds it. Keeping it
        # costed (not inf) preserves explicit-override and tuner
        # legality.
        return 2 * link.launch_s + 2 * (P - 1) * link.alpha_s + ring_bw
    if algo == "rhd":
        if not is_pow2(P):
            return float("inf")
        r = int(log2(P))
        return 2 * r * (link.launch_s + link.alpha_s) \
            + RHD_BW_PENALTY * ring_bw
    if algo == "two_level":
        if not hier_shape or hier_shape[0] * hier_shape[1] != P:
            return float("inf")
        C, L = hier_shape
        cross_link = dcn_link if dcn else ici
        # local RS + local AG over ICI
        t = 2 * ici.launch_s + 2 * max(L - 1, 0) * ici.alpha_s \
            + 2.0 * N * max(L - 1, 0) / max(L, 1) * ici.beta_s_per_byte
        # cross allreduce on the L-fold smaller piece
        t += cross_link.launch_s + 2 * max(C - 1, 0) * cross_link.alpha_s \
            + 2.0 * (N / max(L, 1)) * max(C - 1, 0) / max(C, 1) \
            * cross_link.beta_s_per_byte
        return t
    raise ValueError(f"unknown collective algorithm {algo!r}; expected one "
                     f"of {ALGORITHMS}")


def crossover_bytes(world: int, *, dcn: bool = False,
                    ici: LinkModel = ICI, dcn_link: LinkModel = DCN) -> int:
    """The latency/bandwidth crossover: bucket bytes where the ring's
    hop term equals its byte term (2*(P-1)*alpha == 2*N*(P-1)/P * beta,
    i.e. N* = alpha*P/beta). Below it a bucket is latency-bound (few-hop
    schedules win), above it bandwidth-bound. Also the small/large split
    the autotuner's per-regime categorical dims learn around."""
    link = dcn_link if dcn else ici
    return max(int(link.alpha_s * max(world, 1) / link.beta_s_per_byte), 1)


def hier_legal(world: int, hier_shape: Optional[Tuple[int, int]], *,
               require_cross: bool = True) -> bool:
    """One home for 'is this hierarchy real': a (cross, local) shape
    covering the world with local>1. `require_cross=False` admits the
    degenerate cross==1 mesh — runnable when FORCED (the legacy toggle
    contract) but pointless to auto-select or DCN-compress, since the
    cross phase is a no-op."""
    return bool(hier_shape) and hier_shape[1] > 1 and \
        hier_shape[0] * hier_shape[1] == world and \
        (hier_shape[0] > 1 or not require_cross)


def runnable_algorithms(world: int,
                        hier_shape: Optional[Tuple[int, int]] = None, *,
                        require_cross: bool = True) -> Tuple[str, ...]:
    """Strategies this deployment can structurally run — the ONE home of
    the candidacy rule (selection, the tuner's choice vocabulary and the
    bench sweep all call this): rhd needs a power-of-two world >1,
    two_level a real hierarchy per `hier_legal`."""
    cands = ["direct", "rs_ag"]
    if is_pow2(world) and world > 1:
        cands.append("rhd")
    if hier_legal(world, hier_shape, require_cross=require_cross):
        cands.append("two_level")
    return tuple(cands)


def select_algorithm(nbytes: int, world: int, *,
                     hier_shape: Optional[Tuple[int, int]] = None,
                     dcn: bool = False,
                     ici: LinkModel = ICI,
                     dcn_link: LinkModel = DCN) -> str:
    """Cost-model pick among the structurally legal algorithms.

    `hier_shape` (cross, local) is considered only when both axes are
    real (>1); ties break in `ALGORITHMS` order so selection is
    deterministic — every rank computes the same answer from the same
    (bytes, world, topology) inputs."""
    if world <= 1 or nbytes < MIN_MODEL_BYTES:
        return "direct"
    cands = runnable_algorithms(world, hier_shape)
    return min(cands, key=lambda a: (
        predict_cost(a, nbytes, world, hier_shape=hier_shape, dcn=dcn,
                     ici=ici, dcn_link=dcn_link), ALGORITHMS.index(a)))


def threshold_bytes(cfg, world: int, *, dcn: bool = False) -> int:
    """Small/large bucket split: the explicit
    HOROVOD_COLLECTIVE_ALGO_THRESHOLD when set, else the analytic
    crossover."""
    t = getattr(cfg, "collective_algo_threshold_bytes", 0)
    return t if t > 0 else crossover_bytes(world, dcn=dcn)


def _legalize(algo: str, world: int, hier_ok: bool, *,
              explicit: bool = False) -> str:
    """Map a requested algorithm onto what this bucket/world can run.

    Fallbacks are pure functions of rank-invariant inputs. An EXPLICIT
    env-forced rhd on a non-power-of-two world fails fast (the setting
    can never take effect); two_level falls back silently like the
    legacy hierarchical toggle always did (per-bucket legality — scale,
    join mask, process set — varies call to call by design)."""
    if algo == "rhd" and not (is_pow2(world) and world > 1):
        if explicit:
            raise ValueError(
                f"HOROVOD_COLLECTIVE_ALGO=rhd requires a power-of-two "
                f"world size (recursive halving/doubling); world is "
                f"{world}. Use 'auto', 'direct' or 'rs_ag'.")
        return "direct"
    if algo == "two_level" and not hier_ok:
        return "direct"
    return algo


def resolve(cfg, nbytes: int, world: int, *, requested: Optional[str] = None,
            hier_ok: bool = False,
            hier_shape: Optional[Tuple[int, int]] = None,
            dcn: bool = False) -> str:
    """Resolve the allreduce algorithm for one bucket.

    Precedence: per-call `requested` > explicit HOROVOD_COLLECTIVE_ALGO
    > legacy hierarchical/torus toggles > autotuner-learned per-regime
    choices (small/large split at `threshold_bytes`) > analytic cost
    model. All inputs are round-synchronized config or bucket
    properties, so resolution is rank-invariant by construction.
    """
    req = (requested or "").strip().lower() or None
    explicit = requested is not None
    if req is None:
        if cfg.collective_algo != "auto":
            req = cfg.collective_algo
            explicit = cfg.collective_algo_set
        elif cfg.hierarchical_allreduce or cfg.torus_allreduce:
            req = "two_level"
    if req is not None and req != "auto":
        if req not in ALGORITHMS:
            raise ValueError(
                f"unknown collective algorithm {req!r}; expected one of "
                f"{ALGO_CHOICES}")
        return _legalize(req, world, hier_ok, explicit=explicit)
    small = getattr(cfg, "collective_algo_small", "")
    large = getattr(cfg, "collective_algo_large", "")
    if small or large:
        cand = small if nbytes < threshold_bytes(cfg, world, dcn=dcn) \
            else large
        if cand and cand != "auto":
            return _legalize(cand, world, hier_ok)
    return select_algorithm(nbytes, world,
                            hier_shape=hier_shape if hier_ok else None,
                            dcn=dcn)
