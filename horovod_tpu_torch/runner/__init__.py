"""horovod_tpu_torch.runner: process launch.

The port's copy of the part of ``horovod_tpu/runner`` the serving fleet
needs: ``hosts.SlotInfo`` (one launched process's identity) and
``exec.WorkerProcess`` / ``exec.spawn_local`` (process-group isolation,
a log sink, terminate and kill of the whole group). The launcher's slot
plan (``slot_env``, ``build_command``, ``launch_slots``, ssh) is a later
slice (``ROADMAP.md`` item 12b).
"""
from .exec import WorkerProcess, spawn_local                  # noqa: F401
from .hosts import SlotInfo                                   # noqa: F401
