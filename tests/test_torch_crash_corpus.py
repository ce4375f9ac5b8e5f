"""The checkpoint crash corpus, replayed on the port's manager.

The port's own copies of the crash runners of ``tests/corpus_runner.py``
(``run_ckpt_fused_crash``: a save's epoch drain killed mid-flush, then a
device crash with an arbitrary eviction subset; ``run_restore_fused_crash``:
a device crash, then a restore killed mid-leaf-assembly), on CPU tensors
through ``repro_torch.persistence.CheckpointManager``, each under
``kernel_impl="fused"`` and ``"staged"``. They replay the checked-in cases
of ``tests/test_crash_corpus.py``, and each case must also recover the
same ``(crashed, step, bytes)`` as the JAX package's runner on the same
case: that runner runs unchanged, and what each of its two arms returns
is read as it returns (``sys.setprofile``).
"""

import os
import sys

import numpy as np
import pytest
import torch

import corpus_runner
from repro_torch.core.costmodel import PMemCostModel
from repro_torch.persistence import (CheckpointConfig, CheckpointManager,
                                     from_numpy, to_numpy)
from test_crash_corpus import CKPT_FUSED_CORPUS, RESTORE_FUSED_CORPUS

CM = PMemCostModel(hbm_read_bw_gbps=819.0)


class SimCrash(BaseException):
    """Raised by the failpoint to cut a protocol mid-flight. Derived from
    BaseException so no protocol-level handler can eat it."""


class CrashAt:
    """Failpoint callable: crash at the Nth protocol point reached."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.seen = 0

    def __call__(self, point: str) -> None:
        self.seen += 1
        if self.seen == self.n:
            raise SimCrash(point)


def manager(path, impl) -> CheckpointManager:
    cfg = CheckpointConfig(page_size=128 * 1024, manifest_capacity=1 << 16,
                           kernel_impl=impl)
    return CheckpointManager(path, cfg, device="cpu", cost_model=CM)


def outcome(crashed, step, got):
    return crashed, step, {k: v.tobytes() for k, v in
                           sorted(to_numpy(got).items())}


def assert_state_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), \
            (what, k)


def run_ckpt_fused_crash(tmpdir, sparse_positions, crash_step, seed, prob):
    """The port's ``corpus_runner.run_ckpt_fused_crash``: saves full →
    full rewrite → sparse → sparse (the µLog path); the last save's epoch
    drain dies after ``crash_step - 1`` page flushes, the device crashes
    with an eviction subset drawn from ``seed`` and ``prob``, and a fresh
    manager restores. Both kernel arms recover the same committed cut,
    byte for byte; returns ``(crashed, step, bytes)``."""

    def one_run(impl):
        path = os.path.join(tmpdir, "ckpt-%s.pmem" % impl)
        m = manager(path, impl)
        base = np.random.default_rng(7).standard_normal(131072)
        s = from_numpy({"w": base.astype(np.float32)}, "cpu")  # 4 pages
        m.save(0, s)
        s = {"w": s["w"] + 1.0}                      # full rewrite
        m.save(1, s)
        s = {"w": s["w"].clone()}                    # sparse #1 (CoW)
        for p in sparse_positions:
            s["w"][p] += 1.0
        m.save(2, s)
        committed = {k: v.clone() for k, v in s.items()}
        s = {"w": s["w"].clone()}                    # sparse #2 → µLog
        for p in sparse_positions:
            s["w"][p] += 1.0
        fp = CrashAt(crash_step)
        orig = m._flushq._flush_fn

        def failing(pid, page, dirty, active):
            fp("ckpt_page_flush")
            return orig(pid, page, dirty, active)

        m._flushq._flush_fn = failing
        crashed = False
        try:
            rep = m.save(3, s)
        except SimCrash:
            crashed = True
        m.pmem.crash(rng=np.random.default_rng(seed), evict_prob=prob)

        step, got = manager(path, impl).restore()
        if crashed:
            assert step == 2
            want = committed
        else:
            assert step == 3 and rep.pages_mulog >= 1
            want = s
        assert_state_equal(got, want, (impl, step))
        return outcome(crashed, step, got)

    fused = one_run("fused")
    staged = one_run("staged")
    assert fused == staged, \
        "recovery diverged between the fused and staged scan pipelines"
    return fused


def run_restore_fused_crash(tmpdir, sparse_positions, crash_step, seed,
                            prob):
    """The port's ``corpus_runner.run_restore_fused_crash``: two saves of
    three leaves, a device crash, then a restore killed after
    ``crash_step - 1`` leaf assemblies (``_fused_assemble`` or
    ``_staged_assemble``). Restore is read-only, so a fresh manager
    recovers the committed step byte for byte under both arms; returns
    ``(crashed, step, bytes)``."""

    def one_run(impl):
        path = os.path.join(tmpdir, "restore-%s.pmem" % impl)
        m = manager(path, impl)
        base = np.random.default_rng(11).standard_normal(131072)
        s = from_numpy({"w": base.astype(np.float32),            # 512 KiB
                        "b": np.arange(8192, dtype=np.float32),  # 32 KiB
                        "step_mask": np.arange(4096, dtype=np.uint32)},
                       "cpu")
        m.save(0, s)
        s = {k: v.clone() for k, v in s.items()}
        for p in sparse_positions:
            s["w"][p] += 1.0
        m.save(1, s)
        committed = {k: v.clone() for k, v in s.items()}
        m.pmem.crash(rng=np.random.default_rng(seed), evict_prob=prob)

        m2 = manager(path, impl)
        fp = CrashAt(crash_step)
        for name in ("_fused_assemble", "_staged_assemble"):
            orig = getattr(m2, name)

            def failing(pages, csums, verify, _orig=orig):
                fp("restore_apply")
                return _orig(pages, csums, verify)

            setattr(m2, name, failing)
        crashed = False
        try:
            step, got = m2.restore()
        except SimCrash:
            crashed = True
        if not crashed:
            assert step == 1
            assert_state_equal(got, committed, impl)

        step3, got3 = manager(path, impl).restore()
        assert step3 == 1
        assert_state_equal(got3, committed, impl)
        return outcome(crashed, step3, got3)

    fused = one_run("fused")
    staged = one_run("staged")
    assert fused == staged, \
        "restore recovery diverged between fused and staged apply"
    return fused


def jax_outcomes(runner, *args):
    """Run the JAX package's ``runner`` from ``tests/corpus_runner.py`` as
    it is (with its own assertions) and return what its fused and staged
    arms (its inner ``one_run``) returned."""
    seen = []

    def watch(frame, event, arg):
        code = frame.f_code
        if (event == "return" and code.co_name == "one_run"
                and code.co_filename == corpus_runner.__file__):
            seen.append(arg)

    sys.setprofile(watch)
    try:
        runner(*args)
    finally:
        sys.setprofile(None)
    assert len(seen) == 2
    return seen


@pytest.mark.parametrize("positions,step,seed,prob", CKPT_FUSED_CORPUS)
def test_ckpt_fused_crash_corpus_on_the_port(tmp_path, positions, step,
                                             seed, prob):
    (tmp_path / "port").mkdir()
    got = run_ckpt_fused_crash(str(tmp_path / "port"), positions, step,
                               seed, prob)
    want = jax_outcomes(corpus_runner.run_ckpt_fused_crash,
                        str(tmp_path), positions, step, seed, prob)
    assert want == [got, got]


@pytest.mark.parametrize("positions,step,seed,prob", RESTORE_FUSED_CORPUS)
def test_restore_fused_crash_corpus_on_the_port(tmp_path, positions, step,
                                                seed, prob):
    (tmp_path / "port").mkdir()
    got = run_restore_fused_crash(str(tmp_path / "port"), positions, step,
                                  seed, prob)
    want = jax_outcomes(corpus_runner.run_restore_fused_crash,
                        str(tmp_path), positions, step, seed, prob)
    assert want == [got, got]
