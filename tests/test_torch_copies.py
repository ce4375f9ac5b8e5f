"""The port's copies of the JAX package's host layers stay copies.

``repro_torch`` imports nothing of ``repro``, so it keeps its own copies
of the plain-Python modules it needs. Each copy is read as text (nothing
is imported) beside its reference; both lose their module docstring,
where the port says what it copies, and ``repro.`` becomes
``repro_torch.`` on both sides. What then differs must be one of the
hunks listed in ``DELIBERATE``, each with its reason: any other change,
on either side, fails here until it is carried over or listed.
"""

import ast
import difflib
import pathlib
import re

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "core/__init__", "core/blocks", "core/costmodel", "core/directory",
    "core/log", "core/pageflush", "core/persist", "core/pmem",
    "core/recovery", "core/ssd",
    "pool",
    "io/__init__", "io/engine", "io/flushq", "io/multilog", "io/placer",
    "cluster/__init__", "cluster/shardmap", "cluster/membership",
    "cluster/router",
    "serve/__init__", "serve/frontend", "serve/latency", "serve/workload",
    "serve/modelstate",
    "cache/__init__", "cache/bufmgr",
    "tier/__init__", "tier/spill",
    "persistence/wal",
    "data/__init__", "data/synthetic",
    "models/config",
    "configs/tinyllama_1_1b", "configs/stablelm_12b", "configs/codeqwen15_7b",
    "configs/deepseek_coder_33b", "configs/recurrentgemma_9b",
    "configs/qwen2_vl_7b", "configs/phi35_moe_42b", "configs/deepseek_v2_236b",
    "configs/mamba2_130m", "configs/whisper_large_v3",
]

#: why the KV engine, Pool.kv, the cluster and the front end take a cost
#: model: the port's module model has no device read rate, and a reopen's
#: WAL replay scan is charged at it, so the caller states the rate
COST_KW = ("cost_model= keyword (default: the module's model): the WAL "
           "replay is priced at the device read rate the caller states")

#: module → [(a phrase of the hunk's changed lines, lines removed from
#: the reference, lines added in the port, why)]
DELIBERATE = {
    "core/costmodel": [
        ('"measure_copy_gbps"]', 1, 1, "exports measure_copy_gbps"),
        ("hbm_read_bw_gbps: float = dataclasses.field(kw_only=True)", 8, 9,
         "no default device rate: the TPU's 819 GB/s is not the card's, "
         "so whoever builds a model states the rate"),
        ("math.isnan(self.hbm_read_bw_gbps)", 0, 7,
         "a scan priced without a device rate raises"),
        ("COST_MODEL = PMemCostModel(hbm_read_bw_gbps=math.nan)", 1, 6,
         "the module's model carries no device rate"),
        ("def measure_copy_gbps", 0, 32,
         "the device-memory rate measured on the card (timed copy)"),
    ],
    "pool": [
        ("def kv(self, name: str, cfg=None, *, cost_model=None):", 1, 1,
         COST_KW),
        ("cost_model=cost_model or COST_MODEL)", 3, 5, COST_KW),
    ],
    "core/recovery": [
        ("COST_MODEL, PMemCostModel", 1, 1, COST_KW),
        ("cost_model: PMemCostModel = COST_MODEL,", 0, 1, COST_KW),
        ("self.cost_model = cost_model", 0, 2, COST_KW),
        ("self.cost_model.engine_time_ns(", 1, 1,
         "a reopen's WAL replay scan is priced with the caller's model"),
        ('cost_model=cost_model,\n                   _recover=True)', 2, 4,
         COST_KW),
    ],
    "cluster/router": [
        ("import time", 0, 1, "times the migration copy's device round trip"),
        ("import torch", 0, 1, "the migration copy runs on a torch device"),
        ("COST_MODEL, SSD_COST_MODEL, PMemCostModel", 1, 1, COST_KW),
        ("raise RuntimeError(", 2, 17,
         "ClusterKV(device=, cost_model=): the copy's device (a card unless "
         "the caller asks for the CPU; without a card 'cuda' raises), the "
         "caller's cost model, and the host seconds of the device round "
         "trip that the smoke's cluster path reports"),
        ('cfg.kv, cost_model=cost_model)', 1, 1,
         "each shard's engine prices its WAL replay with the caller's model"),
        ('*, device="cuda",', 1, 2, "ClusterKV.open takes device and "
         "cost_model as the constructor does"),
        ("device=device,", 1, 2, "ClusterKV.open passes them on"),
        ("ns = self.cost_model.engine_time_ns(pool.stats.delta(p0),", 1, 1,
         "migration steps are priced with the caller's model"),
        ("torch.from_numpy(", 1, 4,
         "the range's images go to the device as one uint8 tensor (one "
         "host-to-device copy; the upload is timed)"),
        ("res = apply_unpack(torch.zeros(len(pids) * ps, dtype=torch.uint8,",
         1, 3, "the port's apply_unpack on a zeroed base on the device: a "
         "CUDA device launches the kernel, the CPU takes its plain version"),
        ("out = res.out.cpu().numpy()", 1, 2,
         "the landed bytes come back with one device-to-host copy"),
        ('m["ns_meta"] += self.cost_model.engine_time_ns(', 1, 1,
         "ownership flips are priced with the caller's model"),
        ("vc.transfer_ns += self.cost_model.cluster_transfer_ns(", 1, 1,
         "the interconnect term is priced with the caller's model"),
    ],
    "serve/frontend": [
        ("COST_MODEL, SSD_COST_MODEL, PMemCostModel", 1, 1, COST_KW),
        ("cost_model: PMemCostModel = COST_MODEL) -> None:", 1, 2, COST_KW),
        ("cost_model: prices each batch", 0, 1, COST_KW),
        ("self.cost_model = cost_model", 0, 1, COST_KW),
        ("kv = pool.kv(spec.name, kv_cfg, cost_model=cost_model)", 1, 1,
         "each tenant's engine prices its WAL replay with the caller's model"),
        ("service = self.cost_model.engine_time_ns(", 1, 1,
         "batches are priced with the caller's model"),
    ],
    "data/synthetic": [
        ("from typing import Dict", 1, 1, "Optional is unused"),
        ("import jax.numpy as jnp", 2, 0,
         "the port imports no JAX (the reference's import is unused)"),
    ],
    "models/config": [
        ("from typing import Tuple", 1, 1,
         "Dict, Optional and Sequence are unused"),
    ],
}


def _code(path: pathlib.Path):
    """The file's lines after its module docstring, leading blank lines
    dropped, with ``repro.`` rewritten to ``repro_torch.``."""
    text = path.read_text()
    lines = text.splitlines()
    tree = ast.parse(text)
    if ast.get_docstring(tree, clean=False) is not None:
        lines = lines[tree.body[0].end_lineno:]
    while lines and not lines[0].strip():
        lines.pop(0)
    return [re.sub(r"\brepro\.", "repro_torch.", line) for line in lines]


def _hunks(module: str):
    """``[(removed lines, added lines)]`` of each hunk of the diff."""
    ref = _code(SRC / "repro" / f"{module}.py")
    port = _code(SRC / "repro_torch" / f"{module}.py")
    out = []
    matcher = difflib.SequenceMatcher(None, ref, port, autojunk=False)
    for op, i1, i2, j1, j2 in matcher.get_opcodes():
        if op != "equal":
            out.append((ref[i1:i2], port[j1:j2]))
    return out


@pytest.mark.parametrize("module", COPIES)
def test_copy_differs_only_by_its_listed_hunks(module):
    listed = DELIBERATE.get(module, [])
    unmatched = list(listed)
    stray = []
    for removed, added in _hunks(module):
        text = "\n".join(removed + added)
        hit = [e for e in unmatched if e[0] in text
               and (len(removed), len(added)) == (e[1], e[2])]
        if hit:
            unmatched.remove(hit[0])
        else:
            stray.append("\n".join(["- " + x for x in removed]
                                   + ["+ " + x for x in added]))
    assert not stray, (f"{module}: hunks not listed in DELIBERATE:\n"
                       + "\n\n".join(stray))
    assert not unmatched, (f"{module}: listed hunks not found: "
                           f"{[e[0] for e in unmatched]}")


def test_every_listed_module_is_a_copy():
    assert set(DELIBERATE) <= set(COPIES)
    for module in COPIES:
        assert (SRC / "repro" / f"{module}.py").is_file(), module
        assert (SRC / "repro_torch" / f"{module}.py").is_file(), module
