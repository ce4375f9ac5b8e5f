#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--layers 22]

Phases (any failure exits non-zero):

1. setup — build the four CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once), print the card's name and power
   limit, measure the device-memory rate with a timed device copy (the
   port's cost model prices scans with it), and print what was cut.
2. kernels — each kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes (a bf16 tinyllama-1.1b leaf, an
   f32 leaf of the embedding's shape, 4 KiB blocks, 128 KiB restore
   pages), with ragged-tail, all-clean, all-dirty and corrupted-page cases,
   then on random bytes at further block sizes (16 KiB blocks, a page plus
   a 4 KiB tail); each line gives the kernel's and the plain version's
   times beside the least time the card could take (bytes over 3.35 TB/s).
3. main path — tinyllama-1.1b's 12 parameter leaves at full width on the
   card, from ``--seed``: WAL commit + full save, two seeded partial
   updates each with a WAL commit and a delta save, the pages of a 4th
   save flushed without its manifest, a crash, a fresh manager's restore
   (which must return step 3, tensor for tensor, and the WAL step 3), and
   one more delta save. Launch counts are set to 0 just before it and read
   just after: flush_pack, popcnt_checksum and apply_unpack must be
   positive, dirty_diff 0.
4. staged run — a smaller ``kernel_impl="staged"`` run whose page routing
   must equal the fused arm's on the same saves. Its own counts, set to 0
   just before it: dirty_diff and popcnt_checksum positive, flush_pack 0.

The last line is ``{"ok": true, "device": {...}}``; before it come the
card's name and power limit and one ``{"kernels": [...]}`` line, whose
``launches`` are each kernel's CUDA launches on the path it serves
(``path``: the main path, or the staged run for dirty_diff).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data sheet: HBM3 at 3.35 TB/s; no integer rate is published,
#: so integer work is priced at half the 67 TFLOP/s float32 rate (the SM
#: has half as many INT32 lanes as FP32 lanes)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 33.5e12
PAGE = 128 * 1024
BLOCK = 4096
#: the manifest log's capacity: one manifest entry of the full 2.2 GB state
#: (16,787 pages) is about 0.6 MB of JSON, so CheckpointConfig's default
#: of 1 MiB holds a single save
MANIFEST = 64 << 20
#: the device every phase runs on (a rehearsal on the CPU sets "cpu")
DEV = "cuda"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` on the card over ``reps`` calls after one
    warm-up, between CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def copy_rate_gbps() -> float:
    """Device-memory rate: bytes read plus written by a 2 GiB device copy
    over its time (CUDA events, 10 copies)."""
    import torch
    n = 1 << 31
    x = torch.ones(n, dtype=torch.uint8, device=DEV)
    y = torch.empty_like(x)
    ms = cuda_ms(lambda: y.copy_(x), reps=10)
    del x, y
    torch.cuda.empty_cache()
    return 2 * n / (ms * 1e-3) / 1e9


def bound_ms(nbytes: int, int_ops: int) -> tuple:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = int_ops / PEAK_INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------------------------ kernels

def kernel_phase(state, seed: int) -> dict:
    """Each kernel against its plain version (``impl="ref"``) on the card,
    bit for bit. Returns the timing row of each kernel's main-path case."""
    import torch
    from repro_torch.kernels import (apply_unpack, dirty_blocks, flush_pack,
                                     popcount_blocks)
    from repro_torch.kernels.common import as_bytes, nblocks_for

    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    big_name = max(state, key=lambda k: state[k].numel())
    big = state[big_name]                                  # bf16 leaf
    f32 = torch.randn(32000, 2048, generator=gen, device=DEV)  # f32 leaf
    ragged = torch.randn(3001, generator=gen, device=DEV)      # 12004 B

    def sparse(t):
        cur = t.clone()
        flat = cur.view(-1)
        pos = torch.randint(0, flat.numel(), (300,), generator=gen,
                            device=DEV)
        flat[pos] = flat[pos] + 1
        return cur

    def equal(a, b):
        return torch.equal(as_bytes(a.contiguous()), as_bytes(b.contiguous()))

    rows = {}
    checked = 0

    # popcnt_checksum ---------------------------------------------------
    for label, x in (("bf16 " + big_name, big), ("f32 (32000, 2048)", f32),
                     ("ragged f32 (3001,)", ragged)):
        got = popcount_blocks(x)
        want = popcount_blocks(x, impl="ref")
        if not torch.equal(got, want):
            fail(f"popcnt_checksum disagrees with its plain version ({label})")
        checked += 1
    n = big.numel() * big.element_size()
    nb = nblocks_for(n, BLOCK)
    rows["popcnt_checksum"] = dict(
        shape=f"{tuple(big.shape)} bf16, {BLOCK} B blocks",
        ms=cuda_ms(lambda: popcount_blocks(big), 5),
        plain_ms=cuda_ms(lambda: popcount_blocks(big, impl="ref"), 2),
        bytes=n + 4 * nb, ops=n // 2)

    # dirty_diff --------------------------------------------------------
    big_cur = sparse(big)
    cases = (("sparse bf16", big_cur, big), ("all clean", big, big.clone()),
             ("all dirty f32", f32, torch.randn_like(f32)),
             ("ragged", sparse(ragged), ragged))
    for label, a, b in cases:
        got = dirty_blocks(a, b)
        if not torch.equal(got, dirty_blocks(a, b, impl="ref")):
            fail(f"dirty_diff disagrees with its plain version ({label})")
        if label == "all clean" and int(got.sum()) != 0:
            fail("dirty_diff: identical buffers read as dirty")
        if label == "all dirty f32" and int(got.sum()) != got.numel():
            fail("dirty_diff: rewritten buffer reads as clean")
        checked += 1
    rows["dirty_diff"] = dict(
        shape=f"{tuple(big.shape)} bf16 x2, {BLOCK} B blocks",
        ms=cuda_ms(lambda: dirty_blocks(big_cur, big), 5),
        plain_ms=cuda_ms(lambda: dirty_blocks(big_cur, big, impl="ref"), 2),
        bytes=2 * n + 4 * nb, ops=n // 2)

    # flush_pack --------------------------------------------------------
    for label, a, b in cases:
        got = flush_pack(a, b)
        want = flush_pack(a, b, impl="ref")
        same = got.total == want.total and all(
            equal(getattr(got, f), getattr(want, f))
            for f in ("flags", "counts", "offsets", "packed", "index"))
        if not same:
            fail(f"flush_pack disagrees with its plain version ({label})")
        checked += 1
    fp = flush_pack(big_cur, big)
    rows["flush_pack"] = dict(
        shape=f"{tuple(big.shape)} bf16 x2, {BLOCK} B blocks, "
              f"{fp.total} of {nb} dirty",
        ms=cuda_ms(lambda: flush_pack(big_cur, big), 5),
        plain_ms=cuda_ms(lambda: flush_pack(big_cur, big, impl="ref"), 2),
        bytes=2 * n + 16 * nb + 4 + nb * BLOCK, ops=n)
    del fp

    # apply_unpack ------------------------------------------------------
    pages = nblocks_for(n, PAGE)
    packed = torch.zeros(pages * PAGE, dtype=torch.uint8, device=DEV)
    packed[:n] = as_bytes(big)
    ident = torch.arange(pages, dtype=torch.int32, device=DEV)
    exp = popcount_blocks(packed, block_bytes=PAGE, impl="ref").to(torch.int64)
    shuffled = torch.randperm(pages, generator=gen, device=DEV).to(torch.int32)
    corrupt = exp.clone()
    corrupt[pages // 2] += 1
    rbase = torch.zeros(n - 6, dtype=torch.uint8, device=DEV)  # ragged
    for label, base, idx, e, want_bad in (
            ("restore", torch.zeros(pages * PAGE, dtype=torch.uint8,
                                    device=DEV), ident, exp, 0),
            ("shuffled", torch.zeros(pages * PAGE, dtype=torch.uint8,
                                     device=DEV), shuffled, exp, 0),
            ("corrupted page", torch.zeros(pages * PAGE, dtype=torch.uint8,
                                           device=DEV), ident, corrupt, 1),
            ("ragged base", rbase, ident, exp, 0)):
        b_ref = base.clone()
        got = apply_unpack(base, packed, idx, e, block_bytes=PAGE)
        want = apply_unpack(b_ref, packed, idx, e, block_bytes=PAGE,
                            impl="ref")
        if not (equal(got.out, want.out) and torch.equal(got.ok, want.ok)
                and torch.equal(got.counts, want.counts)
                and got.nbad == want.nbad == want_bad):
            fail(f"apply_unpack disagrees with its plain version ({label})")
        checked += 1
    restore_base = torch.zeros(pages * PAGE, dtype=torch.uint8, device=DEV)
    apply_unpack(restore_base, packed, ident, exp, block_bytes=PAGE)
    if not equal(restore_base[:n], as_bytes(big)):
        fail("apply_unpack did not reassemble the leaf")
    rows["apply_unpack"] = dict(
        shape=f"{pages} pages of {PAGE} B ({tuple(big.shape)} bf16)",
        ms=cuda_ms(lambda: apply_unpack(restore_base, packed, ident, exp,
                                        block_bytes=PAGE), 5),
        plain_ms=cuda_ms(lambda: apply_unpack(restore_base, packed, ident,
                                              exp, block_bytes=PAGE,
                                              impl="ref"), 2),
        bytes=2 * pages * PAGE + 20 * pages, ops=pages * PAGE // 2)
    checked += geometry_cases(gen)
    for name, row in rows.items():
        row["max_abs_err"] = 0   # every comparison above is bit for bit
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"])
        print(f"kernel {name}: {row['shape']}: kernel_ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}: {row['bytes']} B at 3.35 TB/s, the H100 "
              f"SXM data sheet figure) max_abs_err=0", flush=True)
    print(f"kernels checked bit for bit against their plain versions in "
          f"{checked} cases: {json.dumps(list(rows))}", flush=True)
    return rows


#: (block_bytes, bytes) beyond the main path's: whole blocks, a ragged
#: 4 KiB tail, 16 KiB blocks with an odd length, a page plus a 4 KiB tail
GEOMETRIES = ((BLOCK, BLOCK * 33), (BLOCK, BLOCK * 7 + 6),
              (16384, 100_002), (PAGE, PAGE * 5 + BLOCK))


def geometry_cases(gen) -> int:
    """All four kernels against their plain versions on random bytes in
    each of ``GEOMETRIES`` (flush_pack with a sparse, a clean and an
    all-dirty snapshot; apply_unpack shuffled with one corrupted block),
    and the wrappers' refusal of a misaligned buffer. Returns the number
    of cases checked."""
    import torch
    from repro_torch.kernels import (apply_unpack, dirty_blocks, flush_pack,
                                     popcount_blocks)
    checked = 0
    for bb, n in GEOMETRIES:
        where = f"{n} B in {bb} B blocks"
        snap = torch.randint(0, 256, (n,), dtype=torch.uint8, device=DEV,
                             generator=gen)
        cur = snap.clone()
        cur[0] ^= 0x5A
        cur[n - 1] ^= 0x5A
        if not torch.equal(popcount_blocks(cur, block_bytes=bb),
                           popcount_blocks(cur, block_bytes=bb, impl="ref")):
            fail(f"popcnt_checksum disagrees with its plain version ({where})")
        if not torch.equal(dirty_blocks(cur, snap, block_bytes=bb),
                           dirty_blocks(cur, snap, block_bytes=bb,
                                        impl="ref")):
            fail(f"dirty_diff disagrees with its plain version ({where})")
        for a, b in ((cur, snap), (snap, snap.clone()), (cur, snap ^ 1)):
            got = flush_pack(a, b, block_bytes=bb)
            want = flush_pack(a, b, block_bytes=bb, impl="ref")
            if got.total != want.total or not all(
                    torch.equal(getattr(got, f), getattr(want, f))
                    for f in ("flags", "counts", "offsets", "packed",
                              "index")):
                fail(f"flush_pack disagrees with its plain version ({where})")
        nb = -(-n // bb)
        packed = torch.zeros(nb * bb, dtype=torch.uint8, device=DEV)
        packed[:n] = cur
        idx = torch.randperm(nb, generator=gen, device=DEV).to(torch.int32)
        exp = popcount_blocks(packed, block_bytes=bb, impl="ref")
        exp = exp.to(torch.int64)
        exp[0] += 1                                   # one corrupted block
        got = apply_unpack(torch.zeros(n, dtype=torch.uint8, device=DEV),
                           packed, idx, exp, block_bytes=bb)
        want = apply_unpack(torch.zeros(n, dtype=torch.uint8, device=DEV),
                            packed, idx, exp, block_bytes=bb, impl="ref")
        if not (got.nbad == want.nbad == 1 and torch.equal(got.out, want.out)
                and torch.equal(got.ok, want.ok)
                and torch.equal(got.counts, want.counts)):
            fail(f"apply_unpack disagrees with its plain version ({where})")
        checked += 4
    if DEV != "cuda":      # a CPU rehearsal: the plain version takes any buffer
        return checked
    x = torch.zeros(BLOCK + 1, dtype=torch.uint8, device=DEV)
    try:
        popcount_blocks(x[1:])
    except ValueError as e:
        if "aligned" not in str(e):
            raise
    else:
        fail("popcnt_checksum took a buffer that is not 16-byte aligned")
    return checked + 1


# ---------------------------------------------------------------- main path

def update(state, gen, step: int, layers: int) -> None:
    """A fine-tune's step: a few hundred rows of ``embed`` and one layer's
    slice of every decoder leaf get new values; the rest stays frozen."""
    import torch
    emb = state["p/embed"]
    rows = torch.randint(0, emb.shape[0], (300,), generator=gen,
                         device=emb.device)
    emb[rows] = (torch.randn((300, emb.shape[1]), generator=gen,
                             device=emb.device) * 0.02).to(emb.dtype)
    layer = step % layers
    for k, t in state.items():
        if k.startswith("p/decoder/"):
            t[layer] = (torch.randn(t[layer].shape, generator=gen,
                                    device=t.device) * 0.02).to(t.dtype)


def report_line(label: str, rep, seconds: float) -> str:
    return f"{label}: wall_s={seconds:.3f} " + json.dumps(dataclasses.asdict(rep))


def flush_without_manifest(m, state) -> None:
    """The pages of a save flushed, its manifest never appended (the
    crash case of tests/test_persistence.py)."""
    import numpy as np
    from repro_torch.persistence.checkpoint import SaveReport
    cfg = m.cfg
    rep = SaveReport(step=-1)
    for name in sorted(state):
        per_page, buf, _ = m._dirty_lines_per_page(name, state[name])
        for i, pid in enumerate(m._leaf_pages[name]):
            page = np.zeros(cfg.page_size, dtype=np.uint8)
            chunk = buf[i * cfg.page_size:(i + 1) * cfg.page_size]
            page[:chunk.size] = chunk
            dirty = (set(range(cfg.blocks_per_page)) if per_page is None
                     else per_page.get(i, set()))
            if dirty or per_page is None:
                m._flush_page(pid, page, sorted(dirty), per_page is None, rep)
    m.pmem.fsync()


def run_saves(path, cfg, cm, state, seed, layers, *, wal=None):
    """Full save, then two updated delta saves; returns the reports and a
    device copy of the last saved state."""
    import torch
    from repro_torch.persistence import CheckpointManager, StepRecord
    gen = torch.Generator(device=DEV).manual_seed(seed + 2)
    m = CheckpointManager(path, cfg, device=DEV, cost_model=cm)
    reports = []
    for step in (1, 2, 3):
        if step > 1:
            update(state, gen, step, layers)
        if wal is not None:
            wal.commit_step(StepRecord(step, step * 1024, (seed, step),
                                       1.0, 0.0, 1.0, time.time_ns()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = m.save(step, state)
        reports.append((rep, time.perf_counter() - t0))
    return m, reports, gen


def main_path(state, seed: int, layers: int, rate_gbps: float,
              tmp: str) -> None:
    import torch
    from repro_torch.core.costmodel import PMemCostModel
    from repro_torch.persistence import CheckpointConfig, CheckpointManager
    from repro_torch.persistence import TrainWAL
    from repro_torch.pool import Pool

    cm = PMemCostModel(hbm_read_bw_gbps=rate_gbps)
    cfg = CheckpointConfig(page_size=PAGE, manifest_capacity=MANIFEST)
    ckpt = os.path.join(tmp, "ckpt.pmem")
    wal_path = os.path.join(tmp, "wal.pmem")
    wal_pool = Pool.create(wal_path, TrainWAL.capacity_for(1024))
    wal = wal_pool.wal("train_wal", capacity_steps=1024)

    m, reports, gen = run_saves(ckpt, cfg, cm, state, seed, layers, wal=wal)
    for step, (rep, s) in zip((1, 2, 3), reports):
        print(report_line(f"save {step}", rep, s), flush=True)
    saved = {k: v.clone() for k, v in state.items()}       # step 3's state
    kinds = [sum(getattr(r, f) for r, _ in reports[1:])
             for f in ("pages_cow", "pages_mulog", "pages_clean")]
    if reports[0][0].pages_cow != reports[0][0].pages_total or 0 in kinds:
        fail(f"delta saves did not mix CoW, µLog and clean pages: {kinds}")

    update(state, gen, 4, layers)
    t0 = time.perf_counter()
    flush_without_manifest(m, state)
    m.pmem.crash(evict=lambda li: False)
    wal_pool.pmem.crash(evict=lambda li: False)
    print(f"save 4: pages flushed without a manifest, then a crash "
          f"(wall_s={time.perf_counter() - t0:.3f})", flush=True)
    del m, state, wal, wal_pool

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m2 = CheckpointManager(ckpt, cfg, device=DEV, cost_model=cm)
    step, got = m2.restore()
    torch.cuda.synchronize()
    print(report_line("restore", m2.last_restore, time.perf_counter() - t0),
          flush=True)
    if step != 3:
        fail(f"restore returned step {step}, expected 3")
    if set(got) != set(saved):
        fail("restore returned another key set")
    for k, t in got.items():
        if t.device.type != torch.device(DEV).type or t.shape != saved[k].shape \
                or t.dtype != saved[k].dtype:
            fail(f"restored {k}: {t.device} {tuple(t.shape)} {t.dtype}")
        if not torch.equal(t, saved[k]):
            fail(f"restored {k} differs from save 3's state")
        if not bool(torch.isfinite(t).all()):
            fail(f"restored {k} holds non-finite values")
    wal_last = Pool.open(wal_path).wal("train_wal").last
    if wal_last is None or wal_last.step != 3:
        fail(f"WAL recovered {wal_last}, expected step 3")
    print(f"restore: step 3, {len(got)} tensors equal to save 3's on "
          f"{torch.cuda.get_device_name(0)}; WAL recovered step "
          f"{wal_last.step}", flush=True)
    del saved

    update(got, gen, 5, layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = m2.save(5, got)
    print(report_line("save 5 (after restore)", rep,
                      time.perf_counter() - t0), flush=True)
    if rep.pages_clean == 0 or rep.pages_cow + rep.pages_mulog == 0:
        fail("the save after restore did not delta-diff against the "
             "restored snapshot")
    del m2, got


def staged_path(seed: int, layers: int, rate_gbps: float, tmp: str,
                counted) -> dict:
    """The ``kernel_impl="staged"`` arm (dirty_diff) on a few full-width
    leaves, against the fused arm on the same saves. ``counted(fn)`` runs
    ``fn`` between zeroed and read launch counts; the staged run goes
    through it, and its counts are returned."""
    import torch
    from repro_torch.core.costmodel import PMemCostModel
    from repro_torch.persistence import CheckpointConfig
    from repro_torch.persistence.state import TINYLLAMA_1_1B_PARAMS, init_state

    table = {k: TINYLLAMA_1_1B_PARAMS[k] for k in
             ("embed", "final_norm", "decoder/seg0/b0/attn/wk",
              "decoder/seg0/b0/norm1")}
    cm = PMemCostModel(hbm_read_bw_gbps=rate_gbps)
    routes = {}
    for impl in ("fused", "staged"):
        state = init_state(table, seed=seed, device=DEV, layers=layers)
        cfg = CheckpointConfig(page_size=PAGE, manifest_capacity=MANIFEST,
                               kernel_impl=impl)
        saves = lambda: run_saves(os.path.join(tmp, f"{impl}.pmem"), cfg, cm,
                                  state, seed, layers)
        if impl == "staged":
            launches, (m, reports, _) = counted(saves)
        else:
            m, reports, _ = saves()
        routes[impl] = [(r.pages_cow, r.pages_mulog, r.pages_clean,
                         r.blocks_written) for r, _ in reports]
        print(f"{impl} run (4 leaves): (cow, mulog, clean, blocks_written) "
              f"per save = {routes[impl]}; wall_s = "
              f"{[round(s, 3) for _, s in reports]}", flush=True)
        del m, state
    if routes["fused"] != routes["staged"]:
        fail("staged and fused saves routed pages differently")
    return launches


# --------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=22,
                    help="decoder depth (tinyllama-1.1b has 22); width is "
                         "never cut")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found; run it from the "
              "repository's root", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import apply_unpack, dirty_blocks, flush_pack
    from repro_torch.kernels import build, popcount_blocks
    from repro_torch.persistence.state import TINYLLAMA_1_1B_PARAMS, init_state

    # 1. setup ----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build(verbose=True)
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v[0]:.2f} s' for k, v in built.items())})",
          flush=True)
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    card = gpu_line()
    print(f"card: {card}", flush=True)
    rate = copy_rate_gbps()
    print(f"device-memory rate (bytes read + written by a 2 GiB device copy "
          f"over its time, {card}): {rate:.1f} GB/s; the port's cost model "
          f"prices scans with it", flush=True)
    cuts = {"model": "tinyllama-1.1b parameters (12 bf16 leaves)",
            "layers": f"{args.layers} of 22",
            "left out": "AdamW f32 moments (they come with the trainer)"}
    print("reduced: " + json.dumps(cuts), flush=True)

    # 2. kernels --------------------------------------------------------
    state = init_state(TINYLLAMA_1_1B_PARAMS, seed=args.seed, device=DEV,
                       layers=args.layers)
    rows = kernel_phase(state, args.seed)
    torch.cuda.empty_cache()

    # 3. main path ------------------------------------------------------
    wrappers = {"flush_pack": flush_pack, "popcnt_checksum": popcount_blocks,
                "apply_unpack": apply_unpack, "dirty_diff": dirty_blocks}

    def counted(fn):
        """``fn()``'s CUDA launches per kernel, counted from 0, and its
        result."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        return {name: w.launches for name, w in wrappers.items()}, out

    def check_launches(path, launches, used, unused):
        print(f"{path}: kernel launches {json.dumps(launches)}", flush=True)
        idle = [k for k in used if launches[k] <= 0]
        if idle:
            fail(f"the {path} never launched {idle}")
        stray = [k for k in unused if launches[k] != 0]
        if stray:
            fail(f"the {path} launched {stray}, which belong to the other arm")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        main_launches, _ = counted(
            lambda: main_path(state, args.seed, args.layers, rate, tmp))
        print(f"main path: {time.perf_counter() - t0:.1f} s", flush=True)
        check_launches("main path", main_launches,
                       ("flush_pack", "popcnt_checksum", "apply_unpack"),
                       ("dirty_diff",))
        del state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        staged_launches = staged_path(args.seed, args.layers, rate, tmp,
                                      counted)
        print(f"staged pair: {time.perf_counter() - t0:.1f} s", flush=True)
        check_launches("staged run", staged_launches,
                       ("dirty_diff", "popcnt_checksum"), ("flush_pack",))
    # each kernel's launches come from the path it serves: the fused main
    # path, or for dirty_diff the staged arm of the same manager
    paths = {name: "main" for name in wrappers}
    paths["dirty_diff"] = "staged"
    launches = {name: (main_launches if paths[name] == "main"
                       else staged_launches)[name] for name in wrappers}

    # report ------------------------------------------------------------
    replaces = {
        "flush_pack": "src/repro/kernels/flush_pack/kernel.py:93",
        "popcnt_checksum": "src/repro/kernels/popcnt_checksum/kernel.py:38",
        "apply_unpack": "src/repro/kernels/apply_unpack/kernel.py:67",
        "dirty_diff": "src/repro/kernels/dirty_diff/kernel.py:43",
    }
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces[name], "launches": launches[name],
        "path": paths[name],
        "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"], "library_ms": None,
    } for name in replaces]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
