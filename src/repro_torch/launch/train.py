"""The end-to-end training loop, the port of ``repro.launch.train``.

Wires together the model, the synthetic resumable data pipeline,
AdamW, and the persistence stack: a Zero-log WAL committed every step
(one durability barrier on the critical path), CoW/µLog delta
checkpoints every ``ckpt_every`` steps (on a worker thread through
:class:`~repro_torch.persistence.AsyncFlusher` when ``async_flush``),
and crash recovery on restart: the newest checkpoint is restored and the
steps after it replay deterministically from the data cursor.

The checkpointed state is the reference's: ``p/…`` parameter leaves,
then ``o/count``, ``o/m/…`` and ``o/v/…``, so a run checkpointed by
either package resumes under the other. Runs on the card unless
``device="cpu"``:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 20 --batch 4 --seq 64 --out run1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.costmodel import PMemCostModel, measure_copy_gbps
from repro_torch.data import SyntheticPipeline
from repro_torch.launch.steps import build_train_step
from repro_torch.models import Model, init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.persistence import (
    AsyncFlusher,
    CheckpointConfig,
    CheckpointManager,
    StepRecord,
    TrainWAL,
)
from repro_torch.persistence.state import flatten_state, unflatten_state
from repro_torch.pool import Pool

__all__ = ["Trainer", "TrainerConfig", "flatten_state", "main",
           "unflatten_like"]


def unflatten_like(template, flat: Mapping[str, torch.Tensor]):
    """``flat``'s leaves arranged as ``template``'s tree, each cast to the
    template leaf's dtype and reshaped to its shape (a missing key
    raises)."""
    out = {}
    for key, leaf in flatten_state(template).items():
        out[key] = flat[key].to(leaf.dtype).reshape(leaf.shape)
    return unflatten_state(out)


def _default_out() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_run")


@dataclasses.dataclass
class TrainerConfig:
    arch: str = "tinyllama-1.1b"
    reduced: bool = True
    steps: int = 100
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 20
    out: str = dataclasses.field(default_factory=_default_out)
    wal_capacity_steps: int = 100_000
    lr: float = 3e-4
    remat: bool = True
    resume: bool = True
    async_flush: bool = True
    # >1 stripes the WAL over that many zero-log lanes and amortizes
    # `wal_group_commit` steps per persistency barrier
    wal_lanes: int = 1
    wal_group_commit: int = 1
    # >= 2 runs the step WAL on a generation ring: every checkpoint rolls
    # (seals) the live generation and the spill tier retires it to SSD in
    # the same cadence (capacity_steps is then per generation)
    wal_gen_sets: int = 1
    #: where the model trains and the checkpoint scans run
    device: str = "cuda"
    #: the checkpoint's manifest log. One manifest entry of the full-width
    #: tinyllama-1.1b state is ~0.6 MB of JSON, so the default (the JAX
    #: package's) holds one such save; raise it for full-size runs
    manifest_capacity: int = 1 << 20
    #: seed of the parameter init's torch.Generator
    seed: int = 0
    #: decoder depth, cut from the configuration's (None keeps it), and
    #: the encoder's where the configuration has one; a width is never cut
    layers: Optional[int] = None


class Trainer:
    """``Trainer(tc, cost_model=...)``: ``cost_model`` prices the save and
    restore reports; its ``hbm_read_bw_gbps`` is the device's read rate,
    which the caller states (there is no default)."""

    def __init__(self, tc: TrainerConfig, *, cost_model: PMemCostModel) -> None:
        self.tc = tc
        self.device = torch.device(tc.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda'): no CUDA device is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        os.makedirs(tc.out, exist_ok=True)
        self.cfg = get_reduced(tc.arch) if tc.reduced else get_config(tc.arch)
        if tc.layers is not None:
            self.cfg = dataclasses.replace(
                self.cfg, num_layers=int(tc.layers),
                encoder_layers=int(tc.layers) if self.cfg.encoder_layers
                else 0)
        self.pipeline = SyntheticPipeline(self.cfg, tc.batch, tc.seq)
        self.step_fn = build_train_step(
            self.cfg, AdamWConfig(lr=tc.lr), remat=tc.remat,
            total_steps=max(tc.steps, 100))
        # --- persistence ------------------------------------------------
        wal_path = os.path.join(tc.out, "wal.pmem")
        wal_bytes = TrainWAL.capacity_for(tc.wal_capacity_steps,
                                          lanes=tc.wal_lanes,
                                          gen_sets=tc.wal_gen_sets)
        if tc.wal_gen_sets > 1:
            wal_bytes += 1 << 16   # spill-map double buffer + head regions
        self.wal_pool = Pool.open_or_create(wal_path, wal_bytes)
        self.wal_pmem = self.wal_pool.pmem
        self.wal = self.wal_pool.wal(
            "train_wal", capacity_steps=tc.wal_capacity_steps,
            lanes=tc.wal_lanes, group_commit=tc.wal_group_commit,
            gen_sets=tc.wal_gen_sets)
        self.wal_spill = None
        if self.wal.generational:
            # sealed step generations retire to SSD at the checkpoint
            # cadence, bounding the WAL's PMem footprint
            from repro_torch.core.ssd import SSD
            from repro_torch.tier import SpillScheduler
            self.wal_pool.attach_ssd(SSD(1 << 26))
            self.wal_spill = SpillScheduler(self.wal_pool, name="twsp",
                                            map_capacity=1 << 14)
            self.wal.log.attach_spill(self.wal_spill)
        ckpt_path = os.path.join(tc.out, "ckpt.pmem")
        self.manager = CheckpointManager(
            ckpt_path,
            CheckpointConfig(page_size=128 * 1024,
                             manifest_capacity=tc.manifest_capacity),
            device=self.device, cost_model=cost_model)
        self.flusher = AsyncFlusher(self.manager) if tc.async_flush else None

        self.start_step = 0
        params = opt_state = None
        if tc.resume and os.path.exists(ckpt_path) \
                and os.path.getsize(ckpt_path) > 0:
            try:
                step, flat = self.manager.restore()
                tmpl_p = init_params(self.cfg, device="meta")
                tmpl_o = adamw_init(tmpl_p)
                params = unflatten_like(tmpl_p, {
                    k[2:]: v for k, v in flat.items() if k.startswith("p/")})
                opt_state = unflatten_like(tmpl_o, {
                    k[2:]: v for k, v in flat.items() if k.startswith("o/")})
                self.start_step = step
                print(f"[train] restored checkpoint @ step {step}")
                if self.wal.last is not None and self.wal.last.step > step:
                    print(f"[train] WAL ahead at step {self.wal.last.step}; "
                          f"replaying from the checkpoint's data cursor")
            except FileNotFoundError:
                pass
        if params is None:
            params = init_params(self.cfg, tc.seed, device=self.device)
            opt_state = adamw_init(params)
        #: the parameters as ``nn.Parameter``s of a :class:`Model`
        #: (``params.flat()`` gives them under their checkpoint keys)
        self.params, self.opt_state = Model(self.cfg, params), opt_state

    def _ckpt_state(self) -> Dict[str, torch.Tensor]:
        """The checkpointed leaves, live (not copies): ``p/…`` then
        ``o/…``, each part in the JAX package's leaf order."""
        flat = {f"p/{k}": v.detach()
                for k, v in flatten_state(self.params).items()}
        flat.update({f"o/{k}": v
                     for k, v in flatten_state(self.opt_state).items()})
        return flat

    def run(self, crash_at: Optional[int] = None) -> Dict[str, Any]:
        tc = self.tc
        losses = []
        t_start = time.time()
        for step in range(self.start_step, tc.steps):
            if crash_at is not None and step == crash_at:
                # simulated process death: no cleanup, no final flush
                return {"crashed_at": step, "losses": losses}
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            # WAL commit: ONE barrier on the critical path (Zero logging)
            self.wal.commit_step(StepRecord(
                step + 1, step + 1, (0, 0), loss,
                float(metrics["grad_norm"]), 1.0, time.time_ns()),
                sync=tc.wal_group_commit <= 1)
            if (step + 1) % tc.ckpt_every == 0:
                state = self._ckpt_state()
                if self.flusher is not None:
                    self.flusher.submit(step + 1, state)
                else:
                    self.manager.save(step + 1, state)
                if self.wal.generational:
                    self.wal.roll()
                    self.wal_spill.drain()
        self.wal.flush()   # drain any group-commit-buffered steps
        reports = self.flusher.wait() if self.flusher is not None else []
        wall = time.time() - t_start
        return {
            "steps": tc.steps - self.start_step,
            "wall_s": wall,
            "losses": losses,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "wal_barriers_per_step": self.wal.barriers_per_step(),
            "ckpt_reports": [dataclasses.asdict(r) for r in reports][-3:],
        }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--out", default=_default_out())
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--manifest-capacity", type=int, default=1 << 20)
    args = ap.parse_args()
    tc = TrainerConfig(arch=args.arch, reduced=args.reduced, steps=args.steps,
                       batch=args.batch, seq=args.seq,
                       ckpt_every=args.ckpt_every, out=args.out, lr=args.lr,
                       resume=not args.no_resume, device=args.device,
                       manifest_capacity=args.manifest_capacity)
    rate = measure_copy_gbps(args.device)
    report = Trainer(tc, cost_model=PMemCostModel(hbm_read_bw_gbps=rate)).run()
    print(json.dumps({k: v for k, v in report.items() if k != "losses"},
                     indent=1, default=str))
    losses = report["losses"]
    if losses:
        k = max(1, len(losses) // 10)
        print(f"loss: first10={np.mean(losses[:k]):.4f} "
              f"last10={np.mean(losses[-k:]):.4f}")


if __name__ == "__main__":
    main()
