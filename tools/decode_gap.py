#!/usr/bin/env python
"""Decode against the full forward in bf16, on the CPU: the gap, in bf16
ulps of the largest |logit|, between the logits that stepping a sequence
through ``decode_step`` gives and those of one ``forward`` over it, for
the JAX package and for the port, at the reduced widths of mamba2-130m
and whisper-large-v3 and a few depths. ``chip_smoke.py`` takes its
decode-against-forward limits for these two models from these numbers.

Run from the repository root (about a minute on the CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/decode_gap.py
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models as jm
from repro.configs import get_reduced as jax_get_reduced
from repro.data import synthetic_batch
import repro_torch.models as tm
from repro_torch.configs import get_reduced

#: (architecture, layers of the decoder and the encoder, tokens)
CASES = [("mamba2-130m", 4, 64), ("mamba2-130m", 24, 64),
         ("mamba2-130m", 4, 128), ("whisper-large-v3", 2, 64),
         ("whisper-large-v3", 8, 64)]


def _cut(cfg, layers: int):
    return dataclasses.replace(
        cfg, num_layers=layers,
        encoder_layers=layers if cfg.encoder_layers else 0)


def _ulps(dec: np.ndarray, full: np.ndarray) -> float:
    top = float(np.abs(full).max())
    return float(np.abs(dec - full).max()) / 2.0 ** (
        math.floor(math.log2(top)) - 7)


def jax_gap(arch: str, layers: int, n: int) -> float:
    """The JAX package's gap: serving's first step with the frames (an
    encoder-decoder), then ``decode_step``, against ``forward``."""
    cfg = _cut(jax_get_reduced(arch), layers)
    p = jm.init_params(cfg, jax.random.key(0))
    b = synthetic_batch(cfg, 4, n, cursor=0)
    toks = jnp.asarray(b["tokens"])
    extra = {"frames": jnp.asarray(b["frames"])} if "frames" in b else {}
    full, _ = jax.jit(lambda p, bb: jm.forward(p, cfg, bb))(
        p, dict(tokens=toks, **extra))
    c = jm.init_caches(cfg, 4, n, enc_len=n if extra else 0)
    outs, start = [], 0
    if extra:
        out, c = jax.jit(lambda p, t, f, c: jm.forward(
            p, cfg, {"tokens": t, "frames": f}, caches=c,
            cache_pos=jnp.int32(0)))(p, toks[:, :1], extra["frames"], c)
        outs, start = [out], 1
    step = jax.jit(lambda p, t, c, pos: jm.decode_step(p, cfg, t, c, pos))
    for t in range(start, n):
        out, c = step(p, toks[:, t:t + 1], c, jnp.int32(t))
        outs.append(out)
    dec = np.asarray(jnp.concatenate(outs, 1).astype(jnp.float32))
    return _ulps(dec, np.asarray(full.astype(jnp.float32)))


@torch.inference_mode()
def port_gap(arch: str, layers: int, n: int) -> float:
    """The port's gap, the same way (its own seeded parameters)."""
    cfg = _cut(get_reduced(arch), layers)
    p = tm.init_params(cfg, 0, device="cpu")
    b = synthetic_batch(cfg, 4, n, cursor=0)
    toks = torch.from_numpy(b["tokens"])
    extra = ({"frames": torch.from_numpy(b["frames"])} if "frames" in b
             else {})
    full, _ = tm.forward(p, cfg, dict(tokens=toks, **extra))
    c = tm.init_caches(cfg, 4, n, n if extra else 0, device="cpu")
    outs, start = [], 0
    if extra:
        outs = [tm.forward(p, cfg, {"tokens": toks[:, :1], **extra},
                           caches=c, cache_pos=0)[0]]
        start = 1
    for t in range(start, n):
        outs.append(tm.decode_step(p, cfg, toks[:, t:t + 1], c, t)[0])
    return _ulps(torch.cat(outs, 1).float().numpy(), full.float().numpy())


def main() -> None:
    for arch, layers, n in CASES:
        print(f"{arch} reduced, {layers} layers, 4 x {n} tokens, bf16: "
              f"decode - forward {jax_gap(arch, layers, n):.2f} ulps (JAX), "
              f"{port_gap(arch, layers, n):.2f} ulps (port)", flush=True)


if __name__ == "__main__":
    main()
