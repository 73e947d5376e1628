"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed
top-6 [arXiv:2405.04434].

27L d_model=2048 16H, per-expert d_ff=1408, vocab=102400, first layer
dense (d_ff=10944); lite variant has no q LoRA.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    vocab=102400,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    use_mla=True,
    kv_lora=512,
    q_lora=0,
    rope_head_dim=64,
    v_head_dim=128,
    d_ff=10944,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_ff_expert=1408,
    first_dense_layers=1,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="deepseek-lite-smoke",
    n_layers=2,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    kv_lora=64,
    q_lora=0,
    rope_head_dim=16,
    v_head_dim=32,
    d_ff=256,
    n_experts=4,
    n_shared_experts=1,
    moe_top_k=2,
    d_ff_expert=64,
    capacity_factor=4.0,
    dtype="float32",
)
