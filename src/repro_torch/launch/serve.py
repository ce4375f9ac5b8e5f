"""Batched serving loop, the port of ``repro.launch.serve``: the prompt
is stepped through the decode path into the KV caches (an encoder-decoder
runs its encoder on the first prompt token's step, which writes the cross
caches), then tokens are generated one step at a time. Runs on the card
unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --reduced --batch 4 --prompt-len 32 --gen 16
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import synthetic_batch
from repro_torch.models import decode_step, forward, init_caches, init_params

__all__ = ["main", "serve_batch"]


@torch.inference_mode()
def serve_batch(cfg, params, prompts: torch.Tensor, gen: int,
                extras: Optional[Dict[str, torch.Tensor]] = None,
                greedy: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, float]:
    """Prefill by stepping ``prompts`` (B, P) through decode, then decode
    ``gen`` tokens, feeding each back. Returns ``(generated tokens (B,
    gen) int32, tokens/s)``, the rate being ``B * (P + gen)`` over the
    wall time from the first prefill step to the last token on the host.

    As in the reference, the first generated token comes from the last
    prompt token fed once more at position ``P``; the argmax runs over the
    padded vocabulary and the token is clamped to ``vocab_size - 1``.
    ``greedy=False`` samples from the softmax of the logits with
    ``generator``, which is then required; those tokens are not the JAX
    package's (``jax.random`` cannot be replayed).

    ``extras["frames"]`` (B, S_enc, D), an encoder-decoder's input: the
    caches hold ``S_enc`` encoder positions, and the first prompt token
    goes through one ``forward`` with the frames at position 0, which
    runs the encoder and writes every layer's cross cache; the rest steps
    through ``decode_step`` without them."""
    if not greedy and generator is None:
        raise ValueError("sampling (greedy=False) takes a torch.Generator")
    B, P = prompts.shape
    device = prompts.device
    frames = extras.get("frames") if extras else None
    caches = init_caches(cfg, B, P + gen,
                         frames.shape[1] if frames is not None else 0,
                         device=device)
    t0 = time.perf_counter()
    start = 0
    if frames is not None:
        # the reference runs ``encode`` once more before this call and
        # drops its result; the port does not repeat that computation
        _, caches = forward(params, cfg, {"tokens": prompts[:, :1],
                                          "frames": frames},
                            caches=caches, cache_pos=0)
        start = 1
    for t in range(start, P):
        _, caches = decode_step(params, cfg, prompts[:, t:t + 1], caches, t)
    out = []
    last = prompts[:, -1:]
    for t in range(P, P + gen):
        logits, caches = decode_step(params, cfg, last, caches, t)
        last_logits = logits[:, -1]                      # (B, V)
        if greedy:
            nxt = torch.argmax(last_logits, dim=-1)[:, None]
        else:
            probs = torch.softmax(last_logits.float(), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)
        nxt = torch.clamp(nxt, max=cfg.vocab_size - 1).to(torch.int32)
        out.append(nxt)
        last = nxt
    toks = torch.cat(out, dim=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    return toks, B * (P + gen) / dt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve --device cuda: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(cfg, args.seed, device=device)
    b = synthetic_batch(cfg, args.batch, args.prompt_len, cursor=0)
    prompts = torch.from_numpy(b["tokens"]).to(device)
    extras = ({"frames": torch.from_numpy(b["frames"]).to(device)}
              if "frames" in b else None)
    toks, tps = serve_batch(cfg, params, prompts, args.gen, extras)
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "generated_shape": list(toks.shape), "tokens_per_s": round(tps, 1),
        "sample": toks[0, :8].tolist(),
    }))


if __name__ == "__main__":
    main()
