"""horovod_tpu_torch.chaos: deterministic, seeded fault injection.

The port's copy of the stdlib-only half of ``horovod_tpu/chaos``:

    plan.py      declarative, SEEDED fault plans (HOROVOD_CHAOS_PLAN —
                 inline JSON or a file path), the reference's kinds,
                 sites, fail-fast parser and ``random_plan`` profiles
    inject.py    the process-global injector behind one attribute read:
                 ``fire`` at a site, ``corrupt_copy`` (one bit flipped
                 from the plan's seeded RNG)

The serve sites (``serve.step``, ``serve.kv``, ``serve.admit``) and the
KV tier's (``kvtier.demote``, ``kvtier.promote``) are wired in
``serve/``. ``detector.py`` holds the accrual core and the training
ranks' heartbeat detector over the native store (``start_detector``,
``stop_detector``, ``get_detector``, ``escalate``).
"""
from .plan import (                                            # noqa: F401
    FAULT_KINDS, FAULT_SITES, ChaosPlan, Fault, PlanError, random_plan,
)
from .inject import (                                          # noqa: F401
    Injector, armed, corrupt_copy, fire, install, install_from_env,
    step_boundary, uninstall,
)


def process_identity():
    """(rank, world) of this PROCESS from the launcher env contract —
    the granularity faults are addressed at (the reference's
    ``horovod_tpu.chaos.process_identity``)."""
    import os

    def _first(*names, default="0"):
        for n in names:
            v = os.environ.get(n)
            if v not in (None, ""):
                return int(v)
        return int(default)

    rank = _first("HOROVOD_PROCESS_ID", "HOROVOD_CROSS_RANK",
                  "HOROVOD_RANK", default="0")
    world = _first("HOROVOD_NUM_PROCESSES", "HOROVOD_CROSS_SIZE",
                   "HOROVOD_SIZE", default="1")
    return rank, world
