"""Model configuration: a copy of the JAX package's ``repro.models.config``.

``ModelConfig`` and ``Segment`` are plain Python; the port keeps its own
copy because ``repro.models`` imports JAX. Field names, defaults and the
padding rules (``padded_vocab``, ``padded_heads``) are the reference's,
so a configuration gives the same parameter shapes in both packages.

A model is a sequence of *segments*; each segment is a stack of a
repeating *pattern unit* of blocks (1 block for uniform archs, e.g. 3 for
RecurrentGemma's rec/rec/attn cycle), its leaves stacked on a leading
layer axis.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig", "Segment", "pad_to"]


def pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class Segment:
    """A scanned stack: ``pattern`` (block kinds of one unit) × ``repeat``."""

    pattern: Tuple[str, ...]   # e.g. ("attn",), ("rec","rec","attn"), ("ssd",)
    repeat: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads (pre-padding)

    # --- attention -------------------------------------------------------
    attn_kind: str = "gqa"         # gqa | mla
    window: int = 0                # >0: local (sliding-window) attention
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) halves

    # --- MLA (deepseek-v2) -------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0    # leading layers with dense FFN
    capacity_factor: float = 1.25

    # --- SSM (mamba2 SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256               # SSD chunk length

    # --- RG-LRU (recurrentgemma) ---------------------------------------------
    lru_width: int = 0
    block_pattern: Tuple[str, ...] = ()   # cycle, e.g. ("rec","rec","attn")

    # --- encoder-decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0

    # --- frontends (stubs per assignment) ----------------------------------------
    frontend: str = "none"         # none | audio_frames | vision_patches

    # --- misc ----------------------------------------------------------------
    ffn_kind: str = "swiglu"       # swiglu | gelu (whisper's plain MLP)
    #: sequence parallelism for the residual stream: shard the scan-carried
    #: activations (and their remat-saved copies) along S over `model`.
    #: Trades per-layer all-gathers for L× smaller activation memory.
    seq_shard_activations: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad: int = 256
    tp_heads_multiple: int = 16    # pad heads so TP over model axis divides

    # ------------------------------------------------------------------ props

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad)

    @property
    def raw_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_heads(self) -> int:
        return pad_to(self.num_heads, self.tp_heads_multiple)

    @property
    def padded_kv_heads(self) -> int:
        # KV heads: shard over model axis when divisible, else replicate.
        # If q-heads were padded, keep the q/kv group ratio an integer.
        if self.num_kv_heads == self.num_heads:
            return self.padded_heads
        return self.num_kv_heads

    @property
    def padded_ssm_heads(self) -> int:
        return pad_to(self.ssm_heads, self.tp_heads_multiple) if self.ssm_heads else 0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def segments(self) -> Tuple[Segment, ...]:
        """Decoder segments (encoder handled separately for enc-dec)."""
        if self.family == "ssm":
            return (Segment(("ssd",), self.num_layers),)
        if self.block_pattern:
            unit = len(self.block_pattern)
            full = self.num_layers // unit
            rem = self.num_layers - full * unit
            segs = [Segment(tuple(self.block_pattern), full)]
            if rem:
                segs.append(Segment(tuple(self.block_pattern[:rem]), 1))
            return tuple(segs)
        if self.family == "moe" and self.first_dense_layers:
            return (
                Segment(("attn",), self.first_dense_layers),
                Segment(("attn_moe",), self.num_layers - self.first_dense_layers),
            )
        if self.family == "moe":
            return (Segment(("attn_moe",), self.num_layers),)
        if self.family == "audio":
            return (Segment(("xattn",), self.num_layers),)  # decoder w/ cross
        return (Segment(("attn",), self.num_layers),)

    @property
    def encoder_segments(self) -> Tuple[Segment, ...]:
        if not self.encoder_layers:
            return ()
        return (Segment(("enc",), self.encoder_layers),)

    # ------------------------------------------------------------- counting

    def param_count(self) -> int:
        """Analytic parameter count (unpadded dims; used for 6·N·D roofline)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D
        hd = self.raw_head_dim

        def attn_params() -> int:
            if self.attn_kind == "mla":
                q = (self.q_lora_rank and
                     D * self.q_lora_rank
                     + self.q_lora_rank * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                     ) or D * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                kv = D * (self.kv_lora_rank + self.qk_rope_dim)
                kv += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                o = self.num_heads * self.v_head_dim * D
                return q + kv + o
            q = D * self.num_heads * hd
            kv = 2 * D * self.num_kv_heads * hd
            o = self.num_heads * hd * D
            return q + kv + o

        def dense_ffn() -> int:
            return (2 if self.ffn_kind == "gelu" else 3) * D * F

        def moe_ffn() -> int:
            e = self.num_experts * 3 * D * self.moe_d_ff
            e += self.num_shared_experts * 3 * D * self.moe_d_ff
            e += D * self.num_experts  # router
            return e

        def rec_block() -> int:
            # Griffin recurrent block: two input branches D→W, temporal conv,
            # RG-LRU gates (2 × W×W), Λ, and the output projection W→D.
            W = self.lru_width or D
            return 2 * D * W + self.conv_kernel * W + 2 * W * W + W + W * D

        def ssd_block() -> int:
            di, H, N = self.d_inner, self.ssm_heads, self.ssm_state
            return D * 2 * di + D * 2 * N + D * H + self.conv_kernel * di + di * D

        # count by iterating logical layers
        count = 0
        for seg in self.segments:
            for _ in range(seg.repeat):
                for kind in seg.pattern:
                    if kind == "attn":
                        count += attn_params() + dense_ffn() + 2 * D
                    elif kind == "attn_moe":
                        count += attn_params() + moe_ffn() + 2 * D
                    elif kind == "rec":
                        count += rec_block() + dense_ffn() + 2 * D
                    elif kind == "ssd":
                        count += ssd_block() + 2 * D
                    elif kind == "xattn":
                        count += 2 * attn_params() + dense_ffn() + 3 * D
                    elif kind == "enc":
                        count += attn_params() + dense_ffn() + 2 * D
        total += count
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                total += attn_params() + dense_ffn() + 2 * D
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        inactive = (self.num_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = self.num_layers - self.first_dense_layers
        return full - n_moe_layers * inactive
