#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--layers 22] [--train-layers 2]
                          [--serve-layers 22] [--cluster-pages 32768]

Phases (any failure exits non-zero):

1. setup — build the seven CUDA kernels from the six sources in
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all at
   once), print the card's name and power limit, measure the
   device-memory rate with a timed device copy (the port's cost model
   prices scans with it), and print what was cut.
2. kernels — each kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes (the bf16 tinyllama-1.1b leaf
   ``ffn/up``, an f32 leaf of the embedding's shape, 4 KiB blocks, 128 KiB
   restore pages), with ragged-tail, all-clean, all-dirty and
   corrupted-page cases, the delta gather and scatter with a sparse dirty
   set and with every block, float blocks holding ±0 and NaN for the
   dirty flags, then on random bytes at further block sizes (16 KiB
   blocks, a page plus a 4 KiB tail); each line gives the kernel's and the
   plain version's times beside the least time the card could take (bytes
   over 3.35 TB/s) and, for the gather and the scatter, the time of the
   one PyTorch call that computes the same function; then the trainer's
   leaf kinds: the 4-byte int32 ``o/count`` and the f32 moment
   ``o/m/embed``; last, apply_unpack at the cluster migration copy's
   shapes (a range of 4 KiB pages, 1,024 pages of 4 KiB and of 512 B),
   each also with one corrupted page.
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
5. delta round trip — the staged delta chain over the 12 leaves at full
   width, after a seeded update: per leaf, flush_scan equals dirty_diff +
   popcnt_checksum and flush_pack's flags and counts, pack_dirty equals
   flush_pack's packed rows and ids, and apply_delta of that delta onto
   the snapshot gives back the live leaf. Its own counts: flush_scan,
   delta_pack and delta_apply positive (and 0 on the main path and the
   staged run).
6. trainer path — ``repro_torch.launch.train.Trainer`` on tinyllama-1.1b
   at full width, ``--train-layers`` deep, batch 8 x seq 512: run 1
   trains steps 0-2, saves step 2 and crashes at step 3; run 2 restores
   step 2 tensor for tensor, repeats step 2's loss, and saves step 4
   through ``AsyncFlusher``; a fresh restore returns that save tensor for
   tensor; on 128 tokens the card's logits and loss, its per-leaf
   gradients (``remat=True``, as the train step takes them) and one AdamW
   update fed the CPU's gradients are held against the CPU's. Its own
   counts must equal the prediction from its 37 leaves: popcnt_checksum
   37, flush_pack 111, apply_unpack 74, the rest 0. It prints each
   step's, save's and restore's wall time.
7. serve path — ``repro_torch.launch.serve.serve_batch`` on tinyllama-1.1b
   at full width, ``--serve-layers`` deep (22, the whole model), batch 8,
   prompts of 512 tokens, 128 generated: the tokens lie in the vocabulary;
   the prompt and generated tokens stepped through ``decode_step`` from
   fresh caches give the full forward's logits at every position; row
   0's first 16 decode steps on the card give the CPU's logits and caches.
   It prints tokens/s and the decode step's median. Its own counts: all
   seven kernels 0 (serving touches no checkpoint kernel).
8. cluster path — ``repro_torch.cluster.ClusterKV(device="cuda")``: three
   shards of 4 KiB pages and 64 B values (``--cluster-pages`` of them, 64
   ranges) loaded, checkpointed and given a committed tail of puts, grown
   to four shards 4 ranges at a time and cut at the 8th ownership flip,
   every device crashed, the cluster reopened and the grow resumed. Every
   range is owned by exactly its old or its new owner after the reopen,
   the map is the target after the resume, every written key reads back
   its last committed value, and every moved page the tail did not touch
   has its old durable image on its new owner. Its own counts:
   apply_unpack once per range copied, the other six 0. It prints the
   reshard's and the resume's times and reports, and the host seconds of
   the migration copies with their device round trips.

The last line is ``{"ok": true, "device": {...}}``; before it come the
card's name and power limit, one ``{"cluster_path": {...}}`` line (the
cluster path's apply_unpack launches beside the kernel's time at the
migration's shape) and one ``{"kernels": [...]}`` line, whose
``launches`` are each kernel's CUDA launches on the path it serves
(``path``: the trainer path for flush_pack, popcnt_checksum and
apply_unpack, the staged run for dirty_diff, or the delta round trip for
flush_scan, delta_pack and delta_apply).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
#: the kernel phase's leaf: tinyllama-1.1b's largest, (22, 2048, 5632) bf16
BIG_LEAF = "p/decoder/seg0/b0/ffn/up"
#: the manifest log's capacity: one manifest entry of the full 2.2 GB state
#: (16,787 pages) is about 0.6 MB of JSON, so CheckpointConfig's default
#: of 1 MiB holds a single save
MANIFEST = 64 << 20
#: the device every phase runs on (a rehearsal on the CPU sets "cpu")
DEV = "cuda"
#: the serve path's batch, prompt length and generated tokens
SERVE_BATCH, PROMPT, GEN = 8, 512, 128
#: the cluster path's key space in 4 KiB pages (65,536 halved: see
#: ``cluster_sizes``) and its committed puts after the checkpoint
CLUSTER_PAGES, CLUSTER_TAIL = 32768, 4096


def serve_sizes(layers: int) -> str:
    """What the serve path holds at ``layers`` of tinyllama-1.1b's depth."""
    from repro_torch.persistence.state import TINYLLAMA_1_1B_PARAMS
    n = 0
    for k, (shape, _) in TINYLLAMA_1_1B_PARAMS.items():   # decoder: 22 deep
        n += (math.prod(shape[1:]) * layers if k.startswith("decoder/")
              else math.prod(shape))
    cache = SERVE_BATCH * (PROMPT + GEN) * 4 * 64 * 2 * 2 * layers
    return (f"tinyllama-1.1b at full width, {layers} of 22 layers: {n} "
            f"parameters ({2 * n} B in bf16); batch {SERVE_BATCH} x prompt "
            f"{PROMPT} + {GEN} generated; KV caches {cache} B "
            f"({SERVE_BATCH} x {PROMPT + GEN} slots x 4 kv heads x 64 x k,v "
            f"x 2 B x {layers} layers)")


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
    over its time (CUDA events, 10 copies after one)."""
    import torch
    from repro_torch.core.costmodel import measure_copy_gbps
    rate = measure_copy_gbps(DEV, 1 << 31)
    torch.cuda.empty_cache()
    return rate


def bound_ms(nbytes: int, int_ops: int) -> tuple:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = int_ops / PEAK_INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------------------------ kernels

def kernel_phase(state, seed: int) -> dict:
    """Each kernel against its plain version (``impl="ref"``) on the card,
    bit for bit. Returns the timing row of each kernel's main-path case."""
    import torch
    from repro_torch.kernels import (apply_delta, apply_unpack, dirty_blocks,
                                     flush_pack, flush_scan, pack_delta,
                                     popcount_blocks)
    from repro_torch.kernels.common import as_bytes, nblocks_for

    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    big = state[BIG_LEAF]                                  # bf16 leaf
    f32 = torch.randn(32000, 2048, generator=gen, device=DEV)  # f32 leaf
    ragged = torch.randn(3001, generator=gen, device=DEV)      # 12004 B

    def sparse(t):
        cur = t.clone()
        flat = cur.view(-1)
        pos = torch.randint(0, flat.numel(), (300,), generator=gen,
                            device=DEV)
        flat[pos] = flat[pos] + 1
        return cur

    rows = {}
    checked = 0

    # popcnt_checksum ---------------------------------------------------
    for label, x in (("bf16 " + BIG_LEAF, big), ("f32 (32000, 2048)", f32),
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
    del restore_base, packed, rbase

    # flush_scan --------------------------------------------------------
    for label, a, b in cases:
        flags, counts = flush_scan(a, b)
        want_flags, want_counts = flush_scan(a, b, impl="ref")
        if not (torch.equal(flags, want_flags)
                and torch.equal(counts, want_counts)):
            fail(f"flush_scan disagrees with its plain version ({label})")
        checked += 1
    rows["flush_scan"] = dict(
        shape=f"{tuple(big.shape)} bf16 x2, {BLOCK} B blocks",
        ms=cuda_ms(lambda: flush_scan(big_cur, big), 5),
        plain_ms=cuda_ms(lambda: flush_scan(big_cur, big, impl="ref"), 2),
        bytes=2 * n + 8 * nb, ops=n)

    # delta_pack (gather) and delta_apply (scatter) ----------------------
    sparse_idx = torch.nonzero(dirty_blocks(big_cur, big, impl="ref")
                               ).reshape(-1).to(torch.int32)
    every = torch.arange(nb, dtype=torch.int32, device=DEV)
    shuffled = torch.randperm(nb, generator=gen, device=DEV).to(torch.int32)
    r_idx = torch.tensor([2, 0, 1], dtype=torch.int32, device=DEV)
    for label, src, base, idx in (
            (f"{sparse_idx.numel()} dirty blocks", big_cur, big, sparse_idx),
            ("every block", big_cur, big, every),
            ("every block, shuffled", big_cur, big, shuffled),
            ("ragged f32 (3001,)", sparse(ragged), ragged, r_idx)):
        delta = pack_delta(src, idx)
        if not equal(delta, pack_delta(src, idx, impl="ref")):
            fail(f"delta_pack disagrees with its plain version ({label})")
        got = apply_delta(base.clone(), delta, idx)
        want = apply_delta(base.clone(), delta, idx, impl="ref")
        if not equal(got, want):
            fail(f"delta_apply disagrees with its plain version ({label})")
        if label != "ragged f32 (3001,)" and not equal(got, src):
            fail(f"the delta of {label} did not rebuild the live leaf")
        checked += 2
        del delta, got, want
    delta = pack_delta(big_cur, every)
    base = big.clone()
    blocks = big_cur.view(nb, BLOCK // big.element_size())
    base_blocks = base.view(nb, -1)
    every_long = every.long()
    rows["delta_pack"] = dict(
        shape=f"{tuple(big.shape)} bf16, every one of {nb} {BLOCK} B blocks",
        ms=cuda_ms(lambda: pack_delta(big_cur, every), 5),
        plain_ms=cuda_ms(lambda: pack_delta(big_cur, every, impl="ref"), 2),
        library_ms=cuda_ms(lambda: torch.index_select(blocks, 0, every_long),
                           5),
        library="torch.index_select(blocks, 0, idx)",
        bytes=2 * nb * BLOCK + 4 * nb, ops=0)
    rows["delta_apply"] = dict(
        shape=f"{tuple(big.shape)} bf16, every one of {nb} {BLOCK} B blocks",
        ms=cuda_ms(lambda: apply_delta(base, delta, every), 5),
        plain_ms=cuda_ms(lambda: apply_delta(base, delta, every, impl="ref"),
                         2),
        library_ms=cuda_ms(lambda: base_blocks.index_copy_(0, every_long,
                                                           delta), 5),
        library="blocks.index_copy_(0, idx, upd)",
        bytes=2 * nb * BLOCK + 4 * nb, ops=0)
    del delta, base, base_blocks
    checked += float_flag_cases()
    checked += geometry_cases(gen)
    checked += trainer_leaf_cases(gen)
    for name, row in rows.items():
        row["max_abs_err"] = 0   # every comparison above is bit for bit
        row.setdefault("library_ms", None)
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["ops"])
        lib = ("" if row["library_ms"] is None else
               f" library_ms={row['library_ms']:.4f} ({row['library']})")
        print(f"kernel {name}: {row['shape']}: kernel_ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}: {row['bytes']} B at 3.35 TB/s, the H100 "
              f"SXM data sheet figure){lib} max_abs_err=0", flush=True)
    print(f"kernels checked bit for bit against their plain versions in "
          f"{checked} cases: {json.dumps(list(rows))}", flush=True)
    return rows


def migration_cases(seed: int, ranges: tuple) -> dict:
    """``apply_unpack`` at the migration copy's shapes: ``(block_bytes,
    k)`` for each of ``ranges`` (k pages of random bytes), checksums the
    bare per-page popcounts as the router computes them (numpy uint32 on
    the host), ids ``0..k-1``, onto a zeroed base. Each case holds bit for
    bit against the plain version, and again with one checksum off by one
    (``ok`` 0 there, ``nbad`` 1). Each is timed as launches back to back
    (the kernel) and as the wrapper's call (with its host sync); the first
    case is returned as the cluster path's row."""
    import numpy as np
    import torch
    from repro_torch.kernels import apply_unpack, build
    au_ops = sys.modules["repro_torch.kernels.apply_unpack.ops"]

    gen = torch.Generator(device=DEV).manual_seed(seed + 7)
    row = None
    for bb, k in ranges:
        packed = torch.randint(0, 256, (k * bb,), generator=gen,
                               dtype=torch.uint8, device=DEV)
        host = packed.cpu().numpy()
        exp = np.array([int(np.unpackbits(host[i * bb:(i + 1) * bb]).sum())
                        for i in range(k)], dtype=np.uint32)
        idx = np.arange(k, dtype=np.int32)
        bad = exp.copy()
        bad[k // 2] += 1
        for label, e, want_bad in (("clean", exp, 0), ("one corrupted", bad,
                                                       1)):
            base = torch.zeros(k * bb, dtype=torch.uint8, device=DEV)
            got = apply_unpack(base, packed, idx, e, block_bytes=bb)
            want = apply_unpack(torch.zeros_like(base), packed, idx, e,
                                block_bytes=bb, impl="ref")
            if not (equal(got.out, want.out) and equal(got.out, packed)
                    and torch.equal(got.ok, want.ok)
                    and torch.equal(got.counts, want.counts)
                    and got.nbad == want.nbad == want_bad
                    and (want_bad == 0 or int(got.ok[k // 2]) == 0)):
                fail(f"apply_unpack disagrees with its plain version at the "
                     f"migration's shape ({k} x {bb} B, {label})")
        base = torch.zeros(k * bb, dtype=torch.uint8, device=DEV)
        idx_d = torch.from_numpy(idx).to(DEV)
        exp_d = torch.from_numpy(exp.astype(np.int64)).to(DEV)
        ok = torch.empty(k, dtype=torch.int32, device=DEV)
        counts = torch.empty(k, dtype=torch.int32, device=DEV)
        lib = build.library("apply_unpack", au_ops._SIGNATURES)
        stream = torch.cuda.current_stream().cuda_stream
        # the kernel alone: launches back to back, no host sync between
        ms = cuda_ms(lambda: lib.apply_unpack(
            packed.data_ptr(), bb, k, idx_d.data_ptr(), exp_d.data_ptr(),
            base.data_ptr(), base.numel(), ok.data_ptr(), counts.data_ptr(),
            stream), 50)
        call = cuda_ms(lambda: apply_unpack(base, packed, idx_d, exp_d,
                                            block_bytes=bb), 20)
        plain = cuda_ms(lambda: apply_unpack(base, packed, idx_d, exp_d,
                                             block_bytes=bb, impl="ref"), 5)
        nbytes, ops = 2 * k * bb + 20 * k, k * bb // 2
        bound, by = bound_ms(nbytes, ops)
        print(f"kernel apply_unpack, migration copy: {k} pages of {bb} B: "
              f"bit for bit against its plain version, clean and with one "
              f"corrupted page (ok 0 there, nbad 1); kernel_ms={ms:.4f} "
              f"(launches back to back) call_ms={call:.4f} (the wrapper as "
              f"the router calls it: launch and the host sync on nbad) "
              f"plain_ms={plain:.4f} bound_ms={bound:.4f} ({by}: {nbytes} B "
              f"at 3.35 TB/s)", flush=True)
        if row is None:
            row = dict(shape=f"{k} pages of {bb} B", ms=ms, call_ms=call,
                       plain_ms=plain, bound_ms=bound, bound_by=by,
                       library_ms=None, max_abs_err=0)
    return row


def equal(a, b) -> bool:
    """Same shape, dtype and bytes (so -0.0 is not +0.0, and a NaN equals
    itself)."""
    import torch
    from repro_torch.kernels.common import as_bytes
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        as_bytes(a.contiguous()), as_bytes(b.contiguous()))


def same_flush_pack(got, want) -> bool:
    return got.total == want.total and all(
        equal(getattr(got, f), getattr(want, f))
        for f in ("flags", "counts", "offsets", "packed", "index"))


def trainer_leaf_cases(gen) -> int:
    """The leaf kinds the trainer adds to the checkpoint, against the
    plain versions bit for bit: the 4-byte int32 ``o/count`` (one block
    that is almost all ragged tail) through popcnt_checksum, flush_pack
    and apply_unpack (one 128 KiB restore page, intact and corrupted),
    and the largest f32 moment, ``o/m/embed`` (32000, 2048), through
    flush_pack with 300 rows and with every value updated, as the
    checkpoint passes it (``uint8`` views) and as f32 values. Returns the
    number of cases checked."""
    import torch
    from repro_torch.kernels import apply_unpack, flush_pack, popcount_blocks
    from repro_torch.kernels.common import as_bytes
    checked = 0
    count = torch.tensor(7, dtype=torch.int32, device=DEV)
    cb = as_bytes(count)
    for x in (count, cb):
        if not torch.equal(popcount_blocks(x), popcount_blocks(x, impl="ref")):
            fail("popcnt_checksum disagrees with its plain version (o/count)")
        checked += 1
    prev = as_bytes(torch.tensor(6, dtype=torch.int32, device=DEV))
    for label, snap, flag in (("changed", prev, 1), ("clean", cb.clone(), 0)):
        got = flush_pack(cb, snap)
        if not same_flush_pack(got, flush_pack(cb, snap, impl="ref")) \
                or got.flags.tolist() != [flag]:
            fail(f"flush_pack disagrees with its plain version (o/count, "
                 f"{label})")
        checked += 1
    packed = torch.zeros(PAGE, dtype=torch.uint8, device=DEV)
    packed[:4] = cb
    exp = popcount_blocks(packed, block_bytes=PAGE, impl="ref").to(torch.int64)
    one = torch.zeros(1, dtype=torch.int32, device=DEV)
    for e, nbad in ((exp, 0), (exp + 1, 1)):
        got, want = (apply_unpack(torch.zeros(PAGE, dtype=torch.uint8,
                                              device=DEV), packed, one, e,
                                  block_bytes=PAGE, impl=impl)
                     for impl in ("auto", "ref"))
        if not (equal(got.out, want.out) and torch.equal(got.ok, want.ok)
                and torch.equal(got.counts, want.counts)
                and got.nbad == want.nbad == nbad
                and equal(got.out[:4], cb)):
            fail(f"apply_unpack disagrees with its plain version (o/count, "
                 f"{nbad} bad)")
        checked += 1
    m = torch.randn(32000, 2048, generator=gen, device=DEV) * 1e-3
    g = torch.randn(32000, 2048, generator=gen, device=DEV)
    rows = torch.randint(0, 32000, (300,), generator=gen, device=DEV)
    some = m.clone()
    some[rows] = 0.9 * some[rows] + 0.1 * g[rows]
    every = 0.9 * m + 0.1 * g
    del g
    for label, cur in (("300 rows", some), ("every value", every)):
        for a, b in ((as_bytes(cur), as_bytes(m)), (cur, m)):
            if not same_flush_pack(flush_pack(a, b),
                                   flush_pack(a, b, impl="ref")):
                fail(f"flush_pack disagrees with its plain version "
                     f"(o/m/embed f32, {label}, {a.dtype})")
            checked += 1
    return checked


def float_flag_cases() -> int:
    """dirty_diff, flush_pack and flush_scan on f32, bf16 and f16 blocks
    that hold ±0 and NaN: against their plain versions and the flags
    the reference's value compare gives (±0 equal, NaN != NaN), and on
    the same tensors' uint8 views, where they compare bytes. Returns the
    number of cases checked."""
    import torch
    from repro_torch.kernels import dirty_blocks, flush_pack, flush_scan
    from repro_torch.kernels.common import as_bytes
    checked = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        per = BLOCK // torch.empty((), dtype=dtype).element_size()
        snap = torch.ones(5 * per + 7, dtype=dtype, device=DEV)
        cur = snap.clone()
        snap[[0, 5, per - 1]] = 0.0
        cur[[0, 5, per - 1]] = -0.0            # block 0: ±0, clean
        cur[per + 3] = snap[per + 3] = float("nan")  # 1: NaN both sides
        snap[2 * per + 9] = float("nan")       # 2: NaN against 1.0
        snap[3 * per] = -0.0                   # 3: ±0 and a change
        cur[3 * per] = 0.0
        cur[3 * per + 1] = 2.0
        snap[5 * per + 6] = float("nan")       # 5 (ragged): NaN in snap
        value = torch.tensor([0, 1, 1, 1, 0, 1], dtype=torch.int32,
                             device=DEV)
        byte = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int32,
                            device=DEV)
        for a, b, want in ((cur, snap, value),
                           (as_bytes(cur), as_bytes(snap), byte)):
            where = f"{dtype} {'values' if a.dtype == dtype else 'bytes'}"
            flags = dirty_blocks(a, b)
            fp = flush_pack(a, b)
            ref = flush_pack(a, b, impl="ref")
            scan = flush_scan(a, b)
            if not (torch.equal(flags, want)
                    and torch.equal(dirty_blocks(a, b, impl="ref"), want)):
                fail(f"dirty_diff flags on ±0/NaN blocks ({where}): "
                     f"{flags.tolist()}, want {want.tolist()}")
            if fp.total != ref.total or not all(
                    equal(getattr(fp, f), getattr(ref, f))
                    for f in ("flags", "counts", "offsets", "packed",
                              "index")) or not torch.equal(fp.flags, want):
                fail(f"flush_pack on ±0/NaN blocks ({where})")
            if not (torch.equal(scan[0], want)
                    and torch.equal(scan[1], fp.counts)
                    and all(torch.equal(x, y) for x, y in
                            zip(scan, flush_scan(a, b, impl="ref")))):
                fail(f"flush_scan on ±0/NaN blocks ({where})")
            checked += 3
    return checked


#: (block_bytes, bytes) beyond the main path's: whole blocks, a ragged
#: 4 KiB tail, 16 KiB blocks with an odd length, a page plus a 4 KiB tail
GEOMETRIES = ((BLOCK, BLOCK * 33), (BLOCK, BLOCK * 7 + 6),
              (16384, 100_002), (PAGE, PAGE * 5 + BLOCK))


def geometry_cases(gen) -> int:
    """All seven kernels against their plain versions on random bytes in
    each of ``GEOMETRIES`` (flush_pack with a sparse, a clean and an
    all-dirty snapshot; apply_unpack shuffled with one corrupted block;
    the delta gather and scatter of a shuffled subset with the ragged
    last block in it, and of every block), and the wrappers' refusal of
    a misaligned buffer. Returns the number of cases checked."""
    import torch
    from repro_torch.kernels import (apply_delta, apply_unpack, dirty_blocks,
                                     flush_pack, flush_scan, pack_delta,
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
        scan, scan_ref = (flush_scan(cur, snap, block_bytes=bb, impl=impl)
                          for impl in ("auto", "ref"))
        if not all(torch.equal(x, y) for x, y in zip(scan, scan_ref)):
            fail(f"flush_scan disagrees with its plain version ({where})")
        # half the blocks, the ragged last one among them, in random order
        some = torch.unique(torch.cat([idx[: nb // 2], idx.new_tensor([nb - 1])]))
        some = some[torch.randperm(some.numel(), generator=gen, device=DEV)]
        for ids in (some, idx):
            delta = pack_delta(cur, ids, block_bytes=bb)
            if not torch.equal(delta, pack_delta(cur, ids, block_bytes=bb,
                                                 impl="ref")):
                fail(f"delta_pack disagrees with its plain version ({where})")
            got = apply_delta(snap.clone(), delta, ids, block_bytes=bb)
            want = apply_delta(snap.clone(), delta, ids, block_bytes=bb,
                               impl="ref")
            if not torch.equal(got, want):
                fail(f"delta_apply disagrees with its plain version ({where})")
        if not torch.equal(got, cur):    # every block: the live buffer
            fail(f"the delta of every block did not rebuild it ({where})")
        checked += 7
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


def delta_round_trip(seed: int, layers: int) -> None:
    """The staged delta chain over the 12 leaves at full width: per leaf,
    after a seeded update, flush_scan against dirty_diff, popcnt_checksum
    and flush_pack; pack_dirty against flush_pack's packed rows and ids;
    apply_delta of the delta onto the snapshot against the live leaf."""
    import torch
    from repro_torch.kernels import (apply_delta, dirty_blocks, flush_pack,
                                     flush_scan, pack_dirty, popcount_blocks)
    from repro_torch.persistence.state import TINYLLAMA_1_1B_PARAMS, init_state

    state = init_state(TINYLLAMA_1_1B_PARAMS, seed=seed, device=DEV,
                       layers=layers)
    snaps = {k: v.clone() for k, v in state.items()}
    update(state, torch.Generator(device=DEV).manual_seed(seed + 3), 1, layers)
    dirty = blocks = 0
    for name in sorted(state):
        cur, snap = state[name], snaps.pop(name)
        flags, counts = flush_scan(cur, snap)
        fp = flush_pack(cur, snap)
        if not (torch.equal(flags, dirty_blocks(cur, snap))
                and torch.equal(counts, popcount_blocks(cur))
                and torch.equal(flags, fp.flags)
                and torch.equal(counts, fp.counts)):
            fail(f"flush_scan of {name} disagrees with dirty_diff + "
                 f"popcnt_checksum or flush_pack")
        delta, idx, k = pack_dirty(cur, flags)
        if k != fp.total or not equal(delta, fp.packed[:k]) \
                or not torch.equal(idx, fp.index[:k]):
            fail(f"pack_dirty of {name} disagrees with flush_pack")
        if apply_delta(snap, delta, idx) is not snap or not equal(snap, cur):
            fail(f"apply_delta of {name}'s delta did not rebuild the leaf")
        dirty += k
        blocks += flags.numel()
        del fp, delta, snap
    print(f"delta round trip: {len(state)} leaves, {dirty} of {blocks} "
          f"blocks dirty, each leaf rebuilt from its snapshot and delta",
          flush=True)


def trainer_path(seed: int, layers: int, rate_gbps: float, tmp: str, *,
                 batch: int = 8, seq: int = 512,
                 reduced: bool = False) -> int:
    """The trainer through ``repro_torch.launch.train.Trainer`` at
    tinyllama-1.1b's full width and ``layers`` of its depth (``reduced``
    takes the small CPU test configuration instead, for a rehearsal):

    1. run 1 trains steps 0-2, saves at step 2 (its first save: one
       popcnt_checksum a leaf), and crashes at step 3, the WAL at step 3;
    2. run 2, a fresh trainer on the same directory, restores step 2
       (apply_unpack) tensor for tensor as run 1 saved it, repeats step 2
       with run 1's loss, trains step 3 and saves step 4 through
       ``AsyncFlusher`` on a worker thread (flush_pack);
    3. a fresh manager's restore (apply_unpack) gives back run 2's final
       state tensor for tensor;
    4. the card's logits and loss on batch 0's first row, first 128
       tokens, against the port's CPU forward with the same parameters;
       then the gradients and one AdamW update (``backward_and_adamw``).

    Returns the number of checkpointed leaves."""
    import statistics
    import torch
    from repro_torch.core.costmodel import PMemCostModel
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.models import forward
    from repro_torch.models.layers import softmax_xent
    from repro_torch.persistence import CheckpointConfig, CheckpointManager
    from repro_torch.persistence.state import flatten_state, unflatten_state

    cm = PMemCostModel(hbm_read_bw_gbps=rate_gbps)
    out = os.path.join(tmp, "train")
    tc = dict(arch="tinyllama-1.1b", reduced=reduced, layers=layers,
              steps=4, ckpt_every=2, batch=batch, seq=seq, out=out,
              device=DEV, manifest_capacity=MANIFEST, seed=seed)
    step_s, saves = [], []

    def timed(trainer):
        """Time each train step and each save of ``trainer``; keep a
        device clone of what each save is handed."""
        step_fn, save = trainer.step_fn, trainer.manager.save

        def step(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step_fn(*a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return res

        def saving(step_no, state):
            clone = {k: v.clone() for k, v in state.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = save(step_no, state)
            saves.append((step_no, clone, rep, time.perf_counter() - t0))
            return rep

        trainer.step_fn, trainer.manager.save = step, saving

    # 1. run 1: steps 0-2, save at 2, crash at 3 -------------------------
    t1 = Trainer(TrainerConfig(async_flush=False, **tc), cost_model=cm)
    cfg = t1.cfg
    timed(t1)
    r1 = t1.run(crash_at=3)
    n_leaves = len(t1._ckpt_state())
    nbytes = sum(v.numel() * v.element_size()
                 for v in t1._ckpt_state().values())
    print(f"trainer: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads} "
          f"kv={cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"layers={cfg.num_layers}; {n_leaves} leaves, {nbytes} bytes "
          f"checkpointed; batch {batch} x seq {seq}", flush=True)
    losses1 = r1["losses"]
    if r1.get("crashed_at") != 3 or len(losses1) != 3:
        fail(f"run 1 did not crash at step 3: {r1}")
    if t1.wal.last is None or t1.wal.last.step != 3:
        fail(f"run 1's WAL is at {t1.wal.last}, expected step 3")
    if not all(math.isfinite(x) for x in losses1):
        fail(f"run 1's losses are not finite: {losses1}")
    if abs(losses1[0] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"first loss {losses1[0]} is not within 1.0 of "
             f"ln {cfg.vocab_size}")
    ((step_no, saved, rep1, save1_s),) = saves
    if step_no != 2:
        fail(f"run 1 saved step {step_no}, expected 2")
    print(report_line("trainer save 2 (run 1, first save)", rep1, save1_s),
          flush=True)
    t1.manager.pmem.crash(evict=lambda li: False)
    t1.wal_pmem.crash(evict=lambda li: False)
    del t1
    torch.cuda.empty_cache()

    # 2. run 2: restore step 2, steps 2-3, async save at 4 ----------------
    saves.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t2 = Trainer(TrainerConfig(async_flush=True, **tc), cost_model=cm)
    torch.cuda.synchronize()
    print(report_line("trainer restore (run 2)", t2.manager.last_restore,
                      time.perf_counter() - t0), flush=True)
    if t2.start_step != 2:
        fail(f"run 2 starts at step {t2.start_step}, expected 2")
    live = t2._ckpt_state()
    if list(live) != list(saved):
        fail("run 2's state has another key set than run 1 saved")
    for k, v in live.items():
        if not torch.equal(v, saved[k]):
            fail(f"restored {k} differs from what run 1 saved at step 2")
    del saved, live
    timed(t2)
    r2 = t2.run()
    losses2 = r2["losses"]
    bit_equal = losses2[0] == losses1[2]
    print(f"trainer: losses {losses1!r} (run 1, steps 0-2; ln "
          f"{cfg.vocab_size} = {math.log(cfg.vocab_size):.4f}), "
          f"{losses2!r} (run 2, steps 2-3)", flush=True)
    print(f"trainer: step 2's loss {losses1[2]!r} (run 1) and "
          f"{losses2[0]!r} (run 2 after restore): "
          f"{'bit-equal' if bit_equal else 'not bit-equal'}", flush=True)
    if not math.isclose(losses2[0], losses1[2], rel_tol=1e-4):
        fail("run 2's loss at step 2 differs from run 1's by more than "
             "1e-4 relative")
    if t2.wal.last is None or t2.wal.last.step != 4:
        fail(f"run 2's WAL is at {t2.wal.last}, expected step 4")
    ((step_no, _, rep2, save2_s),) = saves
    if step_no != 4 or rep2.pages_cow == 0 or t2.flusher.errors:
        fail(f"run 2's async save: step {step_no}, {rep2.pages_cow} CoW "
             f"pages, errors {t2.flusher.errors}")
    print(report_line("trainer save 4 (run 2, AsyncFlusher)", rep2,
                      save2_s), flush=True)
    saves.clear()

    # 3. a fresh restore of the async save --------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m3 = CheckpointManager(os.path.join(out, "ckpt.pmem"),
                           CheckpointConfig(page_size=PAGE,
                                            manifest_capacity=MANIFEST),
                           device=DEV, cost_model=cm)
    step_no, got = m3.restore()
    torch.cuda.synchronize()
    print(report_line("trainer fresh restore", m3.last_restore,
                      time.perf_counter() - t0), flush=True)
    live = t2._ckpt_state()
    if step_no != 4 or set(got) != set(live):
        fail(f"the fresh restore returned step {step_no}, expected 4")
    for k, v in live.items():
        if not torch.equal(got[k], v):
            fail(f"the fresh restore's {k} differs from run 2's final state")
    del got, m3

    # 4. the card's model math against the CPU's ---------------------------
    b0 = t2.pipeline.batch_at(0)
    row = {k: torch.from_numpy(v[:1, :128]) for k, v in b0.items()}
    host = unflatten_state({k: v.detach().cpu()
                            for k, v in flatten_state(t2.params).items()})
    mask = row["labels"] >= 0
    labels = torch.clamp(row["labels"], min=0)
    with torch.no_grad():
        card_logits, _ = forward(t2.params, cfg,
                                 {k: v.to(DEV) for k, v in row.items()})
        cpu_logits, _ = forward(host, cfg, row)
        # the loss as lm_loss computes it, from these logits
        card = float(softmax_xent(card_logits, labels.to(DEV), mask.to(DEV)))
        cpu = float(softmax_xent(cpu_logits, labels, mask))
    card_logits = card_logits.cpu()
    rel = abs(card - cpu) / abs(cpu)
    err = float((card_logits.float() - cpu_logits.float()).abs().max())
    top, lim = four_ulps(cpu_logits)
    print(f"trainer: on batch 0's first row ({row['tokens'].shape[1]} "
          f"tokens), max |card - CPU| logit {err!r} (largest |logit| "
          f"{top!r}, limit 4 bf16 ulps = {lim!r}); loss card {card!r}, CPU "
          f"{cpu!r}, relative difference {rel:.3e} (limit 2e-2)", flush=True)
    if not err <= lim:
        fail("the card's logits disagree with the CPU's")
    if not rel <= 2e-2:
        fail("the card's loss disagrees with the CPU's")
    backward_and_adamw(t2, cfg, row, host)
    # run 1's step 0 is the cold one (cuBLAS and allocator set-up)
    med = statistics.median(step_s[1:])
    print(f"trainer: train step wall s {json.dumps([round(x, 4) for x in step_s])}"
          f"; median of the {len(step_s) - 1} after run 1's first "
          f"{med:.4f} s, {batch * seq / med:.1f} tokens/s (after "
          f"torch.cuda.synchronize())", flush=True)
    del t2
    return n_leaves


def four_ulps(x) -> tuple:
    """``(largest |x|, 4 bf16 ulps at it)``: the bound tests/test_torch_model.py
    holds the port's logits to against JAX."""
    top = float(x.float().abs().max())
    return top, 4 * 2.0 ** (math.floor(math.log2(top)) - 7)


def bf16_ulps(a, b):
    """``|a - b|`` of two bf16 tensors in ulps of the larger magnitude of
    each pair (0 where they are equal)."""
    import torch
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return (a - b).abs() / ulp


def backward_and_adamw(trainer, cfg, row, host) -> None:
    """The card's backward pass and AdamW step against the CPU's, on
    ``row`` at the trainer's width and depth: per-leaf gradients of
    ``lm_loss(remat=True)`` (relative L2 <= 3e-2, the bound of
    tests/test_torch_model.py); then ``adamw_update`` on both sides, both
    fed the CPU's gradients at the trainer's count (where warmup_cosine is
    above 0): moments within 1e-5 of each leaf's largest value, the new
    bf16 parameters within 1 ulp."""
    import torch
    from repro_torch.models import lm_loss
    from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
    from repro_torch.persistence.state import flatten_state, unflatten_state

    def grads_on(params, batch):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in flatten_state(params).items()}
        with torch.enable_grad():
            loss, _ = lm_loss(unflatten_state(leaves), cfg, batch, remat=True)
            g = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, g))

    card = grads_on(trainer.params, {k: v.to(DEV) for k, v in row.items()})
    cpu = grads_on(host, row)
    rel = {k: float(torch.linalg.vector_norm(card[k].cpu().float() - g.float())
                    / torch.linalg.vector_norm(g.float()).clamp_min(1e-30))
           for k, g in cpu.items()}
    worst = max(rel, key=rel.get)
    print(f"trainer: gradients of lm_loss (remat) on the card against the "
          f"CPU's, {len(rel)} leaves: worst relative L2 {rel[worst]!r} "
          f"({worst}; limit 3e-2)", flush=True)
    if not rel[worst] <= 3e-2:
        fail("the card's gradients disagree with the CPU's")
    del card

    count = trainer.opt_state["count"]
    lr_scale = warmup_cosine(count.cpu(), total=max(trainer.tc.steps, 100))
    if not float(lr_scale) > 0:
        fail(f"warmup_cosine({int(count)}) is 0: the update would not move")

    def update_on(device):
        params = unflatten_state({k: v.detach().to(device, copy=True)
                                  for k, v in flatten_state(host).items()})
        opt = unflatten_state({k: v.to(device, copy=True) for k, v in
                               flatten_state(trainer.opt_state).items()})
        grads = unflatten_state({k: g.to(device) for k, g in cpu.items()})
        adamw_update(grads, opt, params, AdamWConfig(lr=trainer.tc.lr),
                     lr_scale.to(device))
        return ({k: v.cpu() for k, v in flatten_state(params).items()},
                {k: v.cpu() for k, v in flatten_state(opt).items()})

    p_card, o_card = update_on(DEV)
    p_cpu, o_cpu = update_on("cpu")
    moments = {k: float((o_card[k] - v).abs().max()
                        / v.abs().max().clamp_min(1e-30))
               for k, v in o_cpu.items() if k.startswith(("m/", "v/"))}
    ulps = {k: float(bf16_ulps(p_card[k], v).max()) for k, v in p_cpu.items()}
    wm, wp = max(moments, key=moments.get), max(ulps, key=ulps.get)
    moved = sum(int((p_cpu[k] != v).sum()) for k, v in
                flatten_state(host).items())
    print(f"trainer: one AdamW update at count {int(count)} (lr scale "
          f"{float(lr_scale)!r}) fed the CPU's gradients, card against CPU: "
          f"worst moment {moments[wm]!r} of the leaf's largest value ({wm}; "
          f"limit 1e-5), worst parameter {ulps[wp]!r} bf16 ulps ({wp}; limit "
          f"1); {moved} parameters moved", flush=True)
    if not moments[wm] <= 1e-5:
        fail("the card's AdamW moments disagree with the CPU's")
    if not ulps[wp] <= 1:
        fail("the card's AdamW parameters disagree with the CPU's")
    if not o_card["count"].item() == o_cpu["count"].item() == int(count) + 1:
        fail("AdamW's count did not advance by one")


# ------------------------------------------------------------------- serve

def decode_profile(params, cfg, tok, caches, pos: int, median_s: float,
                   steps: int = 5) -> None:
    """``steps`` decode steps at ``pos`` under ``torch.profiler``: the
    device activities (kernels, copies, fills) a step runs and their
    summed time, beside the unprofiled median step; the rest of the step
    is the device's idle share. The copies (``aten::copy_``) are listed by
    their input shapes, which name what each one copies."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        for _ in range(steps):
            decode_step(params, cfg, tok, caches, pos)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("serve: decode step device time: not measured (the profiler "
              "recorded no device activity)", flush=True)
        return
    busy = sum(e.time_range.elapsed_us() for e in dev) / steps * 1e-6
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    names = [(e.key[:48], round(e.self_device_time_total / steps, 1))
             for e in top[:6]]
    print(f"serve: decode step under torch.profiler ({steps} steps): "
          f"{len(dev) / steps:.0f} device activities a step, device busy "
          f"{busy:.6f} s a step, {busy / median_s:.1%} of the median step "
          f"(idle {1 - busy / median_s:.1%}); most device us a step: "
          f"{json.dumps(names)}", flush=True)
    copies = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                     if e.key == "aten::copy_"),
                    key=lambda e: -e.self_device_time_total)
    print("serve: aten::copy_ a step by input shapes (device us, calls): "
          + json.dumps([(e.input_shapes, round(e.self_device_time_total
                                               / steps, 1), e.count // steps)
                        for e in copies[:6]]), flush=True)


def serve_path(seed: int, layers: int, *, batch: int = SERVE_BATCH,
               prompt: int = PROMPT, gen: int = GEN,
               cpu_steps: int = 16, reduced: bool = False) -> None:
    """Serving through ``repro_torch.launch.serve`` on tinyllama-1.1b at
    full width and ``layers`` deep (``reduced`` takes the small CPU test
    configuration, for a rehearsal):

    1. ``serve_batch``: ``batch`` prompts of ``prompt`` tokens from the
       synthetic pipeline, ``gen`` greedy tokens, each in the vocabulary;
    2. the sequence ``serve_batch`` fed (the prompt, its last token again
       at position ``prompt``, then every generated token but the last)
       stepped through ``decode_step`` from fresh caches (each step timed
       after ``torch.cuda.synchronize``) against ``forward`` over the
       whole sequence: every position's logits within 4 bf16 ulps of the
       largest; and each generated token's logit in that forward within 4
       bf16 ulps of its position's largest, so the greedy loop chose it;
    3. row 0's first ``cpu_steps`` tokens through ``decode_step`` on the
       card and on the CPU with the same parameters: the logits, and each
       cache leaf's k and v, within 4 bf16 ulps of their largest value."""
    import statistics
    import torch
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import decode_step, forward, init_caches, init_params
    from repro_torch.persistence.state import flatten_state, unflatten_state

    cfg = get_reduced("tinyllama-1.1b") if reduced else \
        get_config("tinyllama-1.1b")
    cfg = dataclasses.replace(cfg, num_layers=layers)
    params = init_params(cfg, seed, device=DEV)
    prompts = torch.from_numpy(
        synthetic_batch(cfg, batch, prompt, cursor=0)["tokens"]).to(DEV)

    # 1. the entry point ---------------------------------------------------
    toks, tps = serve_batch(cfg, params, prompts, gen)
    if tuple(toks.shape) != (batch, gen) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        fail(f"serve_batch gave {tuple(toks.shape)} tokens in "
             f"[{int(toks.min())}, {int(toks.max())}], vocabulary "
             f"{cfg.vocab_size}")
    print(f"serve: serve_batch {batch} x ({prompt} prompt + {gen} generated) "
          f"tokens, {tps:.1f} tokens/s (B*(P+gen) over the wall time); row "
          f"0 begins {toks[0, :8].tolist()}", flush=True)

    # 2. decode (teacher-forced) against the full forward -------------------
    # what serve_batch fed: the prompt, its last token again at position P,
    # then each generated token but the last
    seq = torch.cat([prompts, prompts[:, -1:], toks[:, :-1]], dim=1)
    n = seq.shape[1]
    step_s = []
    with torch.inference_mode():
        full, _ = forward(params, cfg, {"tokens": seq})
        caches = init_caches(cfg, batch, n, device=DEV)
        dec = torch.empty_like(full)
        for t in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode_step(params, cfg, seq[:, t:t + 1], caches,
                                         t)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            dec[:, t] = logits[:, 0]
    top, lim = four_ulps(full)
    err = float((dec.float() - full.float()).abs().max())
    print(f"serve: decode_step over {n} positions x {batch} rows against "
          f"forward over the whole sequence: max |decode - forward| logit "
          f"{err!r} (largest |logit| {top!r}, limit 4 bf16 ulps = {lim!r})",
          flush=True)
    if not err <= lim:
        fail("decode's logits disagree with the full forward's")
    gl = full[:, prompt:].float()                      # (B, gen, V)
    best = gl.max(dim=-1).values
    chosen = torch.gather(gl, -1, toks.long()[..., None])[..., 0]
    glim = 4 * torch.exp2(torch.floor(torch.log2(best.abs())) - 7)
    gap = float(((best - chosen) / glim).max())
    print(f"serve: each generated token's logit in that forward, below its "
          f"position's largest: worst {gap!r} of the limit (4 bf16 ulps of "
          f"the largest; {batch} x {gen} tokens)", flush=True)
    if not gap <= 1:
        fail("serve_batch's greedy tokens are not the forward's argmax")
    med = statistics.median(step_s[1:])
    print(f"serve: decode step ({batch} rows, {n}-slot caches) wall s median "
          f"{med:.6f} of {n - 1} after the first ({step_s[0]:.4f}), min "
          f"{min(step_s):.6f}, max {max(step_s):.6f}; decode {batch / med:.1f} "
          f"tokens/s (after torch.cuda.synchronize())", flush=True)
    decode_profile(params, cfg, seq[:, -1:], caches, n - 1, med)
    del full, dec, caches

    # 3. the card against the CPU -------------------------------------------
    row = seq[:1, :cpu_steps]
    host = unflatten_state({k: v.cpu() for k, v in
                            flatten_state(params).items()})
    out = {}
    with torch.inference_mode():
        for name, p, dev in (("card", params, DEV), ("cpu", host, "cpu")):
            c = init_caches(cfg, 1, cpu_steps, device=dev)
            ls = []
            for t in range(cpu_steps):
                logits, c = decode_step(p, cfg, row[:, t:t + 1].to(dev), c, t)
                ls.append(logits.cpu())
            out[name] = (torch.cat(ls, dim=1),
                         {k: v.cpu() for k, v in flatten_state(c).items()})
    (cl, cc), (hl, hc) = out["card"], out["cpu"]
    top, lim = four_ulps(hl)
    err = float((cl.float() - hl.float()).abs().max())
    worst = []
    for k in hc:
        if k.endswith("/pos"):
            if not torch.equal(cc[k], hc[k]):
                fail(f"the card's cache {k} differs from the CPU's")
            continue
        ctop, clim = four_ulps(hc[k])
        cerr = float((cc[k].float() - hc[k].float()).abs().max())
        worst.append((cerr / clim, k, cerr, ctop, clim))
    ratio, k, cerr, ctop, clim = max(worst)
    print(f"serve: row 0's first {cpu_steps} decode steps, card against CPU "
          f"({layers} layers): max |card - CPU| logit {err!r} (largest "
          f"{top!r}, limit {lim!r}); worst cache leaf {k}: {cerr!r} (largest "
          f"{ctop!r}, limit 4 bf16 ulps = {clim!r})", flush=True)
    if not err <= lim:
        fail("the card's decode logits disagree with the CPU's")
    if not ratio <= 1:
        fail("the card's caches disagree with the CPU's")


# ------------------------------------------------------------------ cluster

class ClusterCut(BaseException):
    """Raised by the cluster path's failpoint hook to cut a view change
    (a BaseException, so no handler of the protocol eats it)."""


class StageClock:
    """A view change's failpoint hook that times it: host seconds between
    consecutive protocol points, summed by the point that ends each
    stretch (``copy:page`` a page landed, ``copy:wal`` a WAL record,
    ``flush:done`` a target's write-back, ``own:committed`` an ownership
    flip, ``invalidate:done`` a source's discard, ``view:committed`` the
    scrub and the commit). ``cut=(point, n)`` raises at the n-th
    ``point``."""

    def __init__(self, cut=None) -> None:
        self.cut = cut
        self.s = {}
        self.n = {}
        self.last = time.perf_counter()

    def __call__(self, point: str) -> None:
        now = time.perf_counter()
        self.s[point] = self.s.get(point, 0.0) + now - self.last
        self.n[point] = self.n.get(point, 0) + 1
        self.last = now
        if self.cut is not None and (point, self.n[point]) == self.cut:
            raise ClusterCut(point)

    def line(self) -> str:
        return ", ".join(f"{k} {v:.3f} ({self.n[k]})" for k, v in
                         sorted(self.s.items(), key=lambda x: -x[1]))


class HostSplit:
    """Host seconds and calls of wrapped callables, by name."""

    def __init__(self) -> None:
        self.s = {}
        self.n = {}
        self._undo = []

    def wrap(self, owner, attr: str, name: str) -> None:
        orig = getattr(owner, attr)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0
                self.n[name] = self.n.get(name, 0) + 1

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def undo(self) -> None:
        while self._undo:
            setattr(*self._undo.pop())


def cluster_sizes(npages: int) -> dict:
    """The cluster path's configuration, for the ``reduced:`` line. Pages
    and values keep ``KVConfig``'s defaults (4 KiB, 64 B); the key space is
    cut (a deployment holds gigabytes, and the engine's host code runs tens
    of us a put): 65,536 pages would be 256 MiB, and the default is half
    of that, since a rehearsal of this path on a CPU took 42.8 s at 16,384
    pages, which scales to ~170 s at 65,536, over the 150 s allowed it."""
    return {"shards": "3 grown to 4, each on its own in-memory pool, plus a "
                      "meta pool for the shard map",
            "pages": f"{npages} of 4096 B ({npages * 4096} B key space, "
                     f"{npages * 64} keys of 64 B values)",
            "cut": f"the key space: {npages} pages of the 65536 (256 MiB) "
                   f"planned; the default halves it, as a CPU rehearsal "
                   f"scaled to ~170 s of host work at 65536",
            "ranges": f"64 of {npages // 64} pages "
                      f"({npages // 64 * 4096} B)",
            "load": f"8 records in every page ({npages * 8} puts), "
                    f"checkpointed, then {CLUSTER_TAIL} committed puts"}


def cluster_path(seed: int, npages: int, rate_gbps: float) -> dict:
    """The sharded KV through ``repro_torch.cluster.ClusterKV`` on the
    card: a three-shard cluster of 4 KiB pages and 64 B values loaded with
    8 records in every page (from ``seed``), committed and checkpointed,
    then ``CLUSTER_TAIL`` committed puts not checkpointed; a grow to four
    shards 4 ranges at a time, cut at the 8th ownership flip; a crash of
    every device (eviction probability 0.5, the meta pool's too); a reopen
    and ``resume``. Every migration copy verifies and assembles its range
    through ``apply_unpack`` on the card. Checks: each range owned by
    exactly its old or its new owner after the reopen, the target view
    after the resume, every written key's last committed value, and the
    durable image of every moved page the tail did not touch equal, on
    its new owner, to its image before the move. Returns the apply_unpack
    launches the path must have made: one per range copied before the cut
    (its ``flush:done`` points) plus one per range the resume moved."""
    import numpy as np
    from repro_torch.cache import BufferManager
    from repro_torch.cluster import ClusterConfig, ClusterKV
    from repro_torch.core import KVConfig, PersistentKV
    from repro_torch.core.costmodel import PMemCostModel
    from repro_torch.pool import Pool

    cm = PMemCostModel(hbm_read_bw_gbps=rate_gbps)
    cfg = ClusterConfig(kv=KVConfig(npages=npages, page_size=4096,
                                    value_size=64, log_capacity=1 << 22),
                        n_ranges=64)
    rpp = cfg.kv.recs_per_page
    t0 = time.perf_counter()
    meta = Pool.create(None, ClusterKV.meta_pool_bytes(cfg))
    pools = {sid: Pool.create(None, ClusterKV.shard_pool_bytes(cfg))
             for sid in range(4)}
    c = ClusterKV(meta, pools, cfg, shards=range(3), device=DEV,
                  cost_model=cm)
    print(f"cluster: {len(pools)} shard pools of "
          f"{ClusterKV.shard_pool_bytes(cfg)} B and a meta pool of "
          f"{ClusterKV.meta_pool_bytes(cfg)} B built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 1. load: 8 records in every page, committed and checkpointed ------
    rng = np.random.default_rng(seed)
    keys = (np.arange(npages)[:, None] * rpp
            + np.arange(8)[None, :] * (rpp // 8)).reshape(-1)
    values = rng.integers(0, 256, (keys.size + CLUSTER_TAIL, 64),
                          dtype=np.uint8)
    row = {}
    t0 = time.perf_counter()
    for i, k in enumerate(keys.tolist()):
        c.put(k, values[i].tobytes())
        row[k] = i
    c.commit()
    t_put = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.checkpoint()
    t_ckpt = time.perf_counter() - t0
    # 2. a committed tail of puts, not checkpointed ----------------------
    tail = rng.integers(0, cfg.nkeys, CLUSTER_TAIL)
    t0 = time.perf_counter()
    for j, k in enumerate(tail.tolist()):
        c.put(k, values[keys.size + j].tobytes())
        row[k] = keys.size + j
    c.commit()
    t_tail = time.perf_counter() - t0
    print(f"cluster: load {keys.size} puts in {t_put:.2f} s "
          f"({t_put / keys.size * 1e6:.1f} us a put), checkpoint "
          f"{t_ckpt:.2f} s, tail {CLUSTER_TAIL} puts {t_tail:.2f} s",
          flush=True)

    # 3. what the grow moves, and the images to hold it to ----------------
    target = [0, 1, 2, 3]
    before = dict(c.map.owners())
    goal = c.map.assignment(target)
    moving = c.map.moving_ranges(target)
    touched = {int(k) // rpp for k in tail.tolist()}
    kept = {}
    for r in moving:
        eng = c.engine(before[r])
        for pid in c._range_pids(r):
            if pid not in touched:
                kept[pid] = eng.durable_page_image(pid).tobytes()
    print(f"cluster: the grow to {target} moves {len(moving)} of "
          f"{cfg.n_ranges} ranges: {moving}; {len(kept)} of their "
          f"{len(moving) * cfg.pages_per_range} pages untouched by the tail "
          f"are held to their durable images", flush=True)

    split = HostSplit()

    def instrument(cluster):
        split.wrap(cluster, "_copy_pages", "_copy_pages")
        split.wrap(PersistentKV, "durable_page_image", "durable_page_image")
        split.wrap(np, "unpackbits", "np.unpackbits summary")
        split.wrap(BufferManager, "put", "cache.put")

    # 4. the grow, cut at the 8th ownership flip -------------------------
    c.failpoints = clock = StageClock(cut=("own:committed", 8))
    instrument(c)
    t0 = clock.last = time.perf_counter()
    vc = c.begin_reshard(target, width=4)
    try:
        vc.run()
        fail("the cluster's grow ran past its failpoint")
    except ClusterCut:
        pass
    t_reshard = time.perf_counter() - t0
    split.undo()
    copied = clock.n["flush:done"]
    rep1 = vc.report()
    copy_s1 = c.device_copy_s

    # 5. crash every device ----------------------------------------------
    t0 = time.perf_counter()
    crash = np.random.default_rng(seed)
    meta.pmem.crash(rng=crash, evict_prob=0.5)
    for sid in sorted(pools):
        pools[sid].pmem.crash(rng=crash, evict_prob=0.5)
    t_crash = time.perf_counter() - t0
    del c, vc

    # 6. reopen and resume -------------------------------------------------
    t0 = time.perf_counter()
    meta2 = Pool.open(pmem=meta.pmem)
    pools2 = {sid: Pool.open(pmem=p.pmem) for sid, p in pools.items()}
    c2 = ClusterKV.open(meta2, pools2, cfg, device=DEV, cost_model=cm)
    t_reopen = time.perf_counter() - t0
    after = dict(c2.map.owners())
    both = [r for r in range(cfg.n_ranges) if after[r] not in
            (before[r], goal[r])]
    if both:
        fail(f"cluster: ranges {both} are owned by neither their old nor "
             f"their new owner after the reopen")
    flipped = sum(after[r] != before[r] for r in moving)
    print(f"cluster: reopen {t_reopen:.2f} s (crash {t_crash:.2f} s): every "
          f"range owned by exactly its old or its new owner; {flipped} of "
          f"{len(moving)} moving ranges had flipped, view pending "
          f"{c2.map.pending}", flush=True)
    instrument(c2)
    c2.failpoints = clock2 = StageClock()
    t0 = clock2.last = time.perf_counter()
    rep2 = c2.resume(width=4)
    t_resume = time.perf_counter() - t0
    split.undo()
    if rep2 is None or c2.map.pending is not None \
            or dict(c2.map.owners()) != goal \
            or tuple(c2.map.shards) != tuple(target):
        fail("cluster: the resume did not reach the target view")
    print(f"cluster: after the resume the map equals the target assignment "
          f"and no view is pending", flush=True)
    for label, rep, wall, clk in (("grow (cut)", rep1, t_reshard, clock),
                                  ("resume", rep2, t_resume, clock2)):
        print(f"cluster: {label}: wall_s={wall:.3f} ranges committed="
              f"{len(rep.ranges_moved)} pages={rep.pages_moved} "
              f"page_bytes={rep.page_bytes} wal_records="
              f"{rep.wal_records_moved} wal_bytes={rep.wal_bytes} "
              f"modeled engine_ns={rep.engine_ns!r} wall_ns={rep.wall_ns!r}; "
              f"host s by the protocol point ending each stretch (points): "
              f"{clk.line()}", flush=True)
    copy_s = copy_s1 + c2.device_copy_s
    total = split.s.get("_copy_pages", 0.0)
    named = {k: v for k, v in split.s.items() if k != "_copy_pages"}
    rest = total - copy_s - sum(named.values())
    print("cluster: host seconds in _copy_pages over the grow and the resume "
          f"({split.n.get('_copy_pages', 0)} ranges): {total:.3f}, of which "
          f"the device round trip (upload, apply_unpack, download) "
          f"{copy_s:.3f}; "
          + ", ".join(f"{k} {v:.3f} ({split.n[k]} calls)"
                      for k, v in sorted(named.items(), key=lambda x: -x[1]))
          + f"; the rest (the summary's sums, per-page copies, slicing, "
            f"bookkeeping) {rest:.3f}", flush=True)

    # checks ---------------------------------------------------------------
    t0 = time.perf_counter()
    bad = [k for k, i in row.items() if c2.get(k) != values[i].tobytes()]
    if bad:
        fail(f"cluster: {len(bad)} keys do not read back their last "
             f"committed value (first {bad[:5]})")
    differ = [pid for pid, img in kept.items() if
              c2.engine(goal[c2.range_of(pid * rpp)]).durable_page_image(pid)
              .tobytes() != img]
    if differ:
        fail(f"cluster: {len(differ)} moved pages' durable images differ "
             f"from their images before the move (first {differ[:5]})")
    print(f"cluster: {len(row)} written keys read back their last committed "
          f"values; {len(kept)} moved pages' durable images equal on their "
          f"new owners, byte for byte ({time.perf_counter() - t0:.2f} s)",
          flush=True)
    want = copied + len(rep2.ranges_moved)
    print(f"cluster: apply_unpack launches expected {want}: {copied} ranges "
          f"copied before the cut + {len(rep2.ranges_moved)} moved by the "
          f"resume", flush=True)
    return {"expected": want, "reshard_s": t_reshard, "resume_s": t_resume}


# --------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=22,
                    help="decoder depth (tinyllama-1.1b has 22); width is "
                         "never cut")
    ap.add_argument("--train-layers", type=int, default=2,
                    help="decoder depth of the trainer path (its state, "
                         "AdamW moments included, is 2.2 GB at 2 layers)")
    ap.add_argument("--serve-layers", type=int, default=22,
                    help="decoder depth of the serve path (22 is the whole "
                         "model)")
    ap.add_argument("--cluster-pages", type=int, default=CLUSTER_PAGES,
                    help="the cluster path's key space in 4 KiB pages (a "
                         "multiple of 64: 64 ranges)")
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
    from repro_torch.kernels import (apply_delta, apply_unpack, build,
                                     dirty_blocks, flush_pack, flush_scan,
                                     pack_delta, popcount_blocks)
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
    cuts = {"checkpoint paths": "tinyllama-1.1b parameters (12 bf16 "
                                "leaves), random updates",
            "layers": f"{args.layers} of 22",
            "trainer path": "tinyllama-1.1b at full width, trained with "
                            "AdamW (37 leaves with the moments), batch 8 x "
                            "seq 512",
            "trainer layers": f"{args.train_layers} of 22",
            "serve path": serve_sizes(args.serve_layers),
            "cluster path": cluster_sizes(args.cluster_pages)}
    print("reduced: " + json.dumps(cuts), flush=True)

    # 2. kernels --------------------------------------------------------
    state = init_state(TINYLLAMA_1_1B_PARAMS, seed=args.seed, device=DEV,
                       layers=args.layers)
    rows = kernel_phase(state, args.seed)
    ppr = args.cluster_pages // 64
    migration = migration_cases(args.seed, ((BLOCK, ppr), (BLOCK, 1024),
                                            (512, 1024)))
    torch.cuda.empty_cache()

    # 3. main path ------------------------------------------------------
    wrappers = {"flush_pack": flush_pack, "popcnt_checksum": popcount_blocks,
                "apply_unpack": apply_unpack, "dirty_diff": dirty_blocks,
                "delta_pack": pack_delta, "delta_apply": apply_delta,
                "flush_scan": flush_scan}
    delta_chain = ("delta_pack", "delta_apply", "flush_scan")

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
                       ("dirty_diff",) + delta_chain)
        del state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        staged_launches = staged_path(args.seed, args.layers, rate, tmp,
                                      counted)
        print(f"staged pair: {time.perf_counter() - t0:.1f} s", flush=True)
        check_launches("staged run", staged_launches,
                       ("dirty_diff", "popcnt_checksum"),
                       ("flush_pack",) + delta_chain)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trip_launches, _ = counted(lambda: delta_round_trip(args.seed,
                                                         args.layers))
    print(f"delta round trip: {time.perf_counter() - t0:.1f} s", flush=True)
    check_launches("delta round trip", trip_launches, delta_chain,
                   ("apply_unpack",))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        train_launches, leaves = counted(lambda: trainer_path(
            args.seed, args.train_layers, rate, tmp))
        print(f"trainer path: {time.perf_counter() - t0:.1f} s", flush=True)
    check_launches("trainer path", train_launches,
                   ("flush_pack", "popcnt_checksum", "apply_unpack"),
                   ("dirty_diff",) + delta_chain)
    # per leaf (37): one popcnt_checksum on run 1's first save, one
    # apply_unpack on each of the two restores, one flush_pack call (3
    # CUDA launches) on run 2's save
    want = {"popcnt_checksum": leaves, "apply_unpack": 2 * leaves,
            "flush_pack": 3 * leaves}
    if leaves != 37 or {k: train_launches[k] for k in want} != want:
        fail(f"trainer path launches {train_launches}, predicted {want}")
    # each kernel's launches come from the path it serves: the trainer
    # for the three kernels of a training run's checkpoints, the staged
    # arm of the checkpoint manager for dirty_diff, the delta round trip
    # for the staged delta chain
    paths = {name: "trainer" for name in wrappers}
    paths["dirty_diff"] = "staged"
    paths.update({name: "delta round trip" for name in delta_chain})
    by_path = {"trainer": train_launches, "staged": staged_launches,
               "delta round trip": trip_launches}
    launches = {name: by_path[paths[name]][name] for name in wrappers}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_launches, _ = counted(lambda: serve_path(args.seed,
                                                   args.serve_layers))
    print(f"serve path: {time.perf_counter() - t0:.1f} s", flush=True)
    check_launches("serve path", serve_launches, (), tuple(wrappers))
    t0 = time.perf_counter()
    cluster_launches, cluster = counted(lambda: cluster_path(
        args.seed, args.cluster_pages, rate))
    print(f"cluster path: {time.perf_counter() - t0:.1f} s", flush=True)
    check_launches("cluster path", cluster_launches, ("apply_unpack",),
                   tuple(k for k in wrappers if k != "apply_unpack"))
    if cluster_launches["apply_unpack"] != cluster["expected"]:
        fail(f"the cluster path launched apply_unpack "
             f"{cluster_launches['apply_unpack']} times, expected "
             f"{cluster['expected']} (one per range copied)")

    # report ------------------------------------------------------------
    replaces = {
        "flush_pack": "src/repro/kernels/flush_pack/kernel.py:93",
        "popcnt_checksum": "src/repro/kernels/popcnt_checksum/kernel.py:38",
        "apply_unpack": "src/repro/kernels/apply_unpack/kernel.py:67",
        "dirty_diff": "src/repro/kernels/dirty_diff/kernel.py:43",
        "delta_pack": "src/repro/kernels/delta_pack/kernel.py:45",
        "delta_apply": "src/repro/kernels/delta_pack/kernel.py:69",
        "flush_scan": "src/repro/kernels/flush_scan/kernel.py:51",
    }
    sources = {name: name for name in replaces}
    sources["delta_apply"] = "delta_pack"      # one source, two kernels
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{sources[name]}.cu",
        "replaces": replaces[name], "launches": launches[name],
        "path": paths[name],
        "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
        "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"],
    } for name in replaces]
    print(json.dumps({"cluster_path": dict(
        name="apply_unpack", route="cuda",
        source="src/repro_torch/kernels/csrc/apply_unpack.cu",
        replaces=replaces["apply_unpack"],
        launches=cluster_launches["apply_unpack"],
        expected_launches=cluster["expected"],
        reshard_s=cluster["reshard_s"], resume_s=cluster["resume_s"],
        **migration)}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
