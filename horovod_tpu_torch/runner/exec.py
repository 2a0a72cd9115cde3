"""Local process launch with streamed or sunk output.

The port's copy of ``WorkerProcess`` and ``spawn_local`` from
``horovod_tpu/runner/exec.py``: a child runs in a session (and so a
process group) of its own, its merged stdout / stderr is pumped by a
thread into a log file or onto this process's stdout with a
``[rank]<stdout>:`` prefix, and ``terminate`` / ``kill`` signal the
whole group, so nothing the child started outlives it. Only local slots
run here: the ssh path waits for ``ROADMAP.md`` item 12b.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from .hosts import SlotInfo

LOCAL_NAMES = {"localhost", "127.0.0.1"}


def is_local(hostname: str) -> bool:
    return hostname in LOCAL_NAMES or hostname == os.uname().nodename


class WorkerProcess:
    """One launched local slot. ``output_path`` sinks the merged stream
    into that file; ``output_dir`` into ``<dir>/rank.<N>``; with neither,
    it is echoed to this process's stdout, prefixed when
    ``prefix_output``."""

    def __init__(self, slot: SlotInfo, command: List[str],
                 env: Dict[str, str], prefix_output: bool = True,
                 output_dir: Optional[str] = None,
                 output_path: Optional[str] = None,
                 prefix_timestamp: bool = False):
        if not is_local(slot.hostname):
            raise NotImplementedError(
                f"slot on {slot.hostname!r}: remote launch is not ported "
                f"yet (ROADMAP.md item 12b)")
        self.slot = slot
        self.prefix = f"[{slot.rank}]<stdout>:" if prefix_output else ""
        self.prefix_timestamp = prefix_timestamp
        self._sink = None
        if output_path:
            self._sink = open(output_path, "w")
        elif output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._sink = open(
                os.path.join(output_dir, f"rank.{slot.rank}"), "w")
        self.proc = subprocess.Popen(
            command, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, start_new_session=True)
        self._pump = threading.Thread(target=self._stream, daemon=True)
        self._pump.start()

    def _stream(self):
        # the pump OWNS the sink: it closes it at pipe EOF, so a slow
        # drain can never race a close from wait()
        assert self.proc.stdout is not None
        sink = self._sink
        try:
            for line in self.proc.stdout:
                text = line.decode(errors="replace")
                if self.prefix_timestamp:
                    text = time.strftime("%a %b %d %H:%M:%S %Y") \
                        + ": " + text
                if sink is not None:
                    sink.write(text)
                    sink.flush()
                else:
                    sys.stdout.write(f"{self.prefix}{text}")
                    sys.stdout.flush()
        finally:
            if sink is not None:
                sink.close()

    def wait(self, timeout: Optional[float] = None) -> int:
        rc = self.proc.wait(timeout)
        # give the pump time to drain the pipe; it closes the sink itself
        self._pump.join(timeout=10)
        return rc

    def terminate(self) -> None:
        """SIGTERM the whole process group."""
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        """SIGKILL the whole process group: the supervisor's last word
        when a terminate was ignored or a stale incarnation must not
        outlive its replacement."""
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except ProcessLookupError:
            pass

    def poll(self) -> Optional[int]:
        return self.proc.poll()


def spawn_local(command: List[str], env: Dict[str, str], *,
                rank: int = 0, output_path: Optional[str] = None,
                prefix_output: bool = False) -> WorkerProcess:
    """Spawn ONE local process through :class:`WorkerProcess` (process
    group, log sink) without a slot plan: the serving fleet's replica
    spawner uses this, so kill semantics and log plumbing stay in one
    place."""
    slot = SlotInfo(hostname="localhost", rank=rank, local_rank=rank,
                    cross_rank=0, size=1, local_size=1, cross_size=1)
    return WorkerProcess(slot, command, dict(env),
                         prefix_output=prefix_output,
                         output_path=output_path)
