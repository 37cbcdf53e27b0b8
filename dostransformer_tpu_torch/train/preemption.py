"""Graceful preemption of a training run.

A copy of dostransformer_tpu/train/preemption.py (standard library only;
the port imports nothing of the JAX package). Batch schedulers (SLURM,
Kubernetes, spot machines) send SIGTERM and grant a grace window before the
hard kill. GracefulShutdown turns the signal into a REQUEST: the training
loop finishes the epochs in flight, saves a checkpoint at the epoch
boundary, writes its logs and results and exits cleanly, so the follow-up
run loses no completed epoch.

    stop = GracefulShutdown().install()
    try:
        while epoch < epochs:
            ...train...
            if stop.requested:
                ckpt.save(epoch, model, optimizer, tracker)
                break
    finally:
        stop.restore()

A SECOND signal restores the previous handler's behaviour (normally: kill),
so a stuck run can still be ended by signalling twice. Signal handlers can
only be installed from the main thread (a CPython rule); elsewhere install()
does nothing and the flag never trips.
"""

from __future__ import annotations

import signal
import threading


class GracefulShutdown:
    """Latches termination signals into a ``requested`` flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.requested = False
        self._previous: dict = {}

    def _handler(self, signum, frame):
        self.requested = True
        # a second signal must be able to kill a stuck run: restore the
        # previous disposition now that the request is latched
        self.restore()
        print(f"\n[preemption] caught signal {signum}: finishing the "
              "current epochs, then checkpointing and exiting "
              "(signal again to kill)", flush=True)

    def install(self) -> "GracefulShutdown":
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal is main-thread-only (CPython)
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handler)
        return self

    def restore(self) -> None:
        """Put the previous handlers back (idempotent)."""
        while self._previous:
            s, prev = self._previous.popitem()
            signal.signal(s, prev)
