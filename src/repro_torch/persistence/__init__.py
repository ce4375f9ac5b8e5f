"""Training-state persistence on the port's pool.

- :mod:`repro_torch.persistence.checkpoint` — the checkpoint manager:
  pages flushed failure-atomically (CoW + pvn, µLog deltas), manifest
  committed through a Zero log; device scans through the CUDA kernels.
- :mod:`repro_torch.persistence.wal`        — step-granular training WAL
  (Zero logging: one durability barrier per step).
- :mod:`repro_torch.persistence.flusher`    — ``AsyncFlusher``: saves on
  worker threads, overlapped with training.
- :mod:`repro_torch.persistence.state`      — flat state between the JAX
  package's numpy arrays and the port's tensors.

Importing this package builds no kernel: the kernels compile at their
first launch.
"""

from repro_torch.persistence.checkpoint import (  # noqa: F401
    CheckpointConfig,
    CheckpointManager,
    RestoreReport,
    SaveReport,
)
from repro_torch.persistence.flusher import AsyncFlusher  # noqa: F401
from repro_torch.persistence.state import from_numpy, to_numpy  # noqa: F401
from repro_torch.persistence.wal import StepRecord, TrainWAL  # noqa: F401
