"""deepseek-v2-236b [moe] — MLA + 2 shared / 160 routed top-6 [arXiv:2405.04434].

60L d_model=5120 128H, MLA kv_lora=512 (+64 rope), q_lora=1536,
per-expert d_ff=1536, vocab=102400, first layer dense (d_ff=12288).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    vocab=102400,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head latents, no GQA grouping
    head_dim=128,    # q/k nope dim
    use_mla=True,
    kv_lora=512,
    q_lora=1536,
    rope_head_dim=64,
    v_head_dim=128,
    d_ff=12288,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    d_ff_expert=1536,
    first_dense_layers=1,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="deepseek-236b-smoke",
    n_layers=2,
    d_model=128,
    vocab=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    kv_lora=64,
    q_lora=48,
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
