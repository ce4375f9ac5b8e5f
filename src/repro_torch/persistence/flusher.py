"""Asynchronous checkpoint flushing, overlapped with training: the port
of ``repro.persistence.flusher`` as far as the trainer uses it.

Guideline G5 ("performance-critical code should prefer DRAM … buffer writes
in a DRAM cache") becomes: the training loop *stages* its state (a device
copy of every leaf) and returns to compute immediately; one background
worker runs the actual CoW/µLog flushing off the critical path, with at
most ``MAX_PENDING`` staged saves in flight (guideline G4: writer
concurrency is capped).

Ordering contract: saves are serialized in submission order; ``wait()``
drains them — the train loop calls it before intentionally stopping, and
the WAL makes any un-flushed tail recoverable anyway.

Where the reference stages to host memory, the port stages a clone on the
device the state lies on: the port's manager scans leaves where they lie
and refuses a leaf on another device than its own, and the clone is still
a real copy, so the loop may update the live tensors in place right after
``submit``. A worker's error is kept and raised again by :meth:`wait`
and :meth:`close`.

The reference's sharded lanes (a list of managers, ``submit_all``,
``restore_all``) and its ``sockets``, ``cache_frames``, ``cache_admit_k``
and ``kernel_impl`` propagation are not ported: no caller of the port
uses them.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List

import torch

from repro_torch.persistence.checkpoint import CheckpointManager, SaveReport

__all__ = ["AsyncFlusher"]

#: staged saves in flight before ``submit`` blocks (each is a device copy
#: of the whole state)
MAX_PENDING = 2


class AsyncFlusher:
    """Background flusher: one worker thread saving through one manager."""

    def __init__(self, manager: CheckpointManager) -> None:
        self.manager = manager
        self._queue: "queue.Queue" = queue.Queue(maxsize=MAX_PENDING)
        self.reports: List[SaveReport] = []
        self.errors: List[BaseException] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, state = item
            try:
                self.reports.append(self.manager.save(step, state))
            except BaseException as e:  # surfaced on wait()
                self.errors.append(e)
            finally:
                self._queue.task_done()

    @staticmethod
    def stage(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Staging copy on the state's own device (the only synchronous
        cost). Must be a real copy: the training loop updates the live
        tensors in place immediately after submit()."""
        return {k: v.detach().clone() for k, v in state.items()}

    def submit(self, step: int, state: Dict[str, torch.Tensor]) -> None:
        """Stage and enqueue one save; blocks only if ``MAX_PENDING``
        saves are already in flight (back-pressure instead of unbounded
        device memory)."""
        self._queue.put((step, self.stage(state)))

    def wait(self) -> List[SaveReport]:
        self._queue.join()
        if self.errors:
            raise self.errors[0]
        return list(self.reports)

    def close(self) -> List[SaveReport]:
        self._queue.put(None)
        self._queue.join()
        self._worker.join(timeout=60)
        if self.errors:
            raise self.errors[0]
        return list(self.reports)
