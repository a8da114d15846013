"""The preemption signal guard — a copy of
`tfde_tpu/resilience/preemption.py` (`Preempted` :50, `PreemptionGuard`
:60), so that the port never imports the JAX package.

SIGTERM/SIGINT-safe training: pools SIGTERM their workers, and losing up
to save_checkpoints_steps - 1 steps on every preemption is real lost work.

The handler only sets a flag (async-signal-safe); the train loop polls it
each step, breaks, and its normal tail force-saves and waits for the
commit. The first signal also RESTORES the previous handler, so a second
signal kills immediately — the operator's escape hatch if the save itself
wedges. After the commit, the loop re-raises the signal under the restored
handler so the process exits with the signal's semantics (SIGTERM ->
killed-by-15, SIGINT -> KeyboardInterrupt) instead of pretending the run
finished.

Signal handlers can only be installed from the main thread; anywhere else
(the concurrent evaluator, tests driving train() from a worker thread) the
guard is inert and behavior is unchanged.

Known limit, on purpose: a signal landing while the loop is blocked in
next(feed) is acted on when the next batch arrives — a flag-setting handler
is the only one that cannot corrupt the step in flight (a raising handler
would surface at an arbitrary bytecode, e.g. half-way through the
optimizer's in-place update, leaving nothing valid to save). The second
signal (default handler) is the immediate kill.

The supervisor is not ported (it comes with the resilience slice). In the
JAX package it composes with the guard this way: in resume-on-preemption
mode it installs its own outer handler, one that raises `Preempted`,
before it enters the train loop; the guard saves that handler as the
previous one, so the post-commit re-raise lands in the supervisor's
handler, which restarts the loop from the committed checkpoint.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

log = logging.getLogger(__name__)


class Preempted(BaseException):
    """Raised (by a supervisor's outer handler) after a preemption signal's
    checkpoint has committed. BaseException on purpose — an `except
    Exception` inside user data code must not swallow a preemption."""

    def __init__(self, signum: int):
        super().__init__(f"preempted by signal {signum}")
        self.signum = signum


class PreemptionGuard:
    """See module docstring. Context manager; `fired` is the signum of the
    first caught signal, None otherwise."""

    _SIGNUMS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.fired: Optional[int] = None
        self._prev: dict = {}

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self._SIGNUMS:
                try:
                    self._prev[s] = signal.signal(s, self._handle)
                except (ValueError, OSError):  # exotic embedding; stay inert
                    pass
        return self

    def _handle(self, signum, frame):
        self.fired = signum
        signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
        self._prev.pop(signum, None)

    def __exit__(self, *exc) -> bool:
        # list(): a signal landing mid-restore pops from _prev via the
        # still-installed handler; iterating the live dict would raise and
        # swallow the re-raise below
        for s, h in list(self._prev.items()):
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        return False

    def reraise_if_fired(self, saved_step: Optional[int]) -> None:
        if self.fired is None:
            return
        if saved_step is not None:
            log.warning(
                "preemption signal %d: checkpoint at step %d committed; "
                "re-raising", self.fired, saved_step,
            )
        else:
            log.warning(
                "preemption signal %d: NO checkpoint manager configured "
                "(model_dir/save_checkpoints_steps unset) — progress since "
                "start is lost; re-raising", self.fired,
            )
        signal.raise_signal(self.fired)
