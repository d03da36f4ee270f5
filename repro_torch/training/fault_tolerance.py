"""Fault tolerance (counterpart of ``repro.training.fault_tolerance``):
checkpoint cadence and garbage collection, bounded retry of a step,
straggler detection and a preemption flag.

  * ``CheckpointPolicy`` — periodic and on-signal saves; ``gc`` keeps the
    newest ``keep_last`` committed steps.
  * ``retrying`` — the port's ``resilience.retry.retrying``: a step that
    raises a transient error (``RuntimeError``) runs again from the state
    the caller still holds (``train_step`` never writes it).
  * ``StragglerMonitor`` — rolling median of step wall times; a step
    slower than ``threshold × median`` is flagged.
"""

from __future__ import annotations

import dataclasses
import shutil
import signal
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..resilience.retry import retrying  # noqa: F401
from .checkpoint import _step_dir, list_steps

__all__ = ["CheckpointPolicy", "retrying", "StragglerMonitor", "Preemption",
           "install_preemption_handler"]


class Preemption(Exception):
    """Raised into the training loop when a preemption signal arrives."""


@dataclasses.dataclass
class CheckpointPolicy:
    every_steps: int = 100
    keep_last: int = 3
    save_on_preemption: bool = True

    def should_save(self, step: int) -> bool:
        return self.every_steps > 0 and step > 0 and step % self.every_steps == 0

    def gc(self, ckpt_dir: str):
        """Delete all but the newest ``keep_last`` committed checkpoints."""
        steps = list_steps(ckpt_dir)
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


class StragglerMonitor:
    """Rolling median step time; flags steps slower than threshold × median."""

    def __init__(self, window: int = 50, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self._times: Deque[float] = deque(maxlen=window)
        self.flags: List[int] = []
        self._step = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> Tuple[float, bool]:
        dt = time.monotonic() - (self._t0 or time.monotonic())
        flagged = False
        if len(self._times) >= max(self.window // 5, 3):
            med = sorted(self._times)[len(self._times) // 2]
            flagged = dt > self.threshold * med
            if flagged:
                self.flags.append(self._step)
        self._times.append(dt)
        self._step += 1
        return dt, flagged

    def observe(self, dt: float) -> bool:
        """Direct-injection variant for tests and offline analysis."""
        self._t0 = time.monotonic() - dt
        _, flagged = self.stop()
        return flagged


def install_preemption_handler(flag: Dict[str, bool]):
    """SIGTERM sets ``flag["preempted"]``; the train loop checkpoints and
    exits cleanly."""

    def handler(signum, frame):
        flag["preempted"] = True

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread
    return flag
