"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400; q_lora=1536,
qk_nope=128, qk_rope=64, v_head=128; first layer dense (d_ff 12288).
[arXiv:2405.04434; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,              # dense FFN width (first layer)
    vocab_size=102_400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=160,
    top_k=6,
    moe_d_ff=1536,
    num_shared_experts=2,
    first_dense_layers=1,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-smoke", num_layers=3, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
        v_head_dim=32, num_experts=8, top_k=2, moe_d_ff=64,
        num_shared_experts=1, first_dense_layers=1,
        tp_heads_multiple=1, vocab_pad=16)
