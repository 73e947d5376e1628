"""Model configuration shared by all assigned architectures (the port's own
copy of `repro.models.config`; the port runs the dense family so far)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config object spans all six arch families.

    Unused family fields stay at their zero defaults.  `arch_type` selects
    the block pattern in `models.model`:
      dense  — [attn, mlp] * n_layers
      moe    — [attn, mlp] * first_dense_layers + [attn, moe] * rest
      ssm    — [mamba] * n_layers
      hybrid — mamba backbone with one *shared* transformer block applied
               every `attn_every` layers (Zamba2)
      vlm    — dense backbone consuming projected patch embeddings + tokens
      audio  — dense backbone over codec tokens (EnCodec vocab)
    """

    name: str
    arch_type: str
    n_layers: int
    d_model: int
    vocab: int

    # --- attention (GQA) ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window size; None = full causal

    # --- dense mlp ---
    d_ff: int = 0

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0          # 0 => no query low-rank path
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    d_conv: int = 4
    ssm_split_proj: bool = False  # separate z/x/B/C/dt projections (and
    # per-stream convs) so each output dim shards head-aligned over `model`
    # instead of slicing one fused (misaligned) in_proj — see §Perf E4

    # --- hybrid ---
    attn_every: int = 0

    # --- vlm stub frontend ---
    n_patches: int = 0
    vision_dim: int = 0

    # --- numerics / execution ---
    dtype: str = "float32"          # params & activations
    remat: bool = False             # checkpoint each block in train mode
    remat_policy: str = "full"      # "full" | "dots" (save matmul outputs —
                                    # backward skips recomputing them)
    prefill_chunk: int = 0          # >0: chunk prefill queries (memory cap)
    unroll: bool = False            # python-loop layers instead of lax.scan
                                    # (exact HLO cost analysis; probes only)
    use_flash: bool = False         # flash attention kernel (not yet ported)
    use_ssd_kernel: bool = False    # SSD intra-chunk kernel (not yet ported)
    tie_embeddings: bool = True

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def conv_dim(self) -> int:
        # channels passed through the causal depthwise conv: x, B, C streams
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def qk_nope_dim(self) -> int:
        return self.head_dim  # MLA: per-head non-rope dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count N (used for 6·N·D model flops)."""
        d = self.d_model
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        total += d  # final norm
        if self.arch_type in ("vlm",):
            total += self.vision_dim * d
        attn = 0
        if self.use_mla:
            q_in = self.q_lora if self.q_lora else d
            attn += (d * self.q_lora) if self.q_lora else 0
            attn += q_in * self.n_heads * (self.head_dim + self.rope_head_dim)
            attn += d * (self.kv_lora + self.rope_head_dim)
            attn += self.kv_lora * self.n_heads * (self.head_dim + self.v_head_dim)
            attn += self.n_heads * self.v_head_dim * d
        elif self.n_heads:
            attn += d * self.n_heads * self.head_dim
            attn += 2 * d * self.n_kv_heads * self.head_dim
            attn += self.n_heads * self.head_dim * d
        mlp_dense = 3 * d * self.d_ff
        moe = 0
        if self.n_experts:
            moe = (
                d * self.n_experts
                + self.n_experts * 3 * d * self.d_ff_expert
                + self.n_shared_experts * 3 * d * self.d_ff_expert
            )
        mamba = 0
        if self.ssm_state:
            di, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            mamba = (
                d * (2 * di + 2 * g * n + h)  # in_proj
                + self.d_conv * self.conv_dim  # conv
                + 3 * h  # A_log, D, dt_bias
                + di  # gated norm
                + di * d  # out_proj
            )
        if self.arch_type == "dense" or self.arch_type in ("vlm", "audio"):
            total += self.n_layers * (attn + mlp_dense + 4 * d)
        elif self.arch_type == "moe":
            total += self.first_dense_layers * (attn + mlp_dense + 4 * d)
            total += (self.n_layers - self.first_dense_layers) * (attn + moe + 4 * d)
        elif self.arch_type == "ssm":
            total += self.n_layers * (mamba + 2 * d)
        elif self.arch_type == "hybrid":
            total += self.n_layers * (mamba + 2 * d)
            total += attn + mlp_dense + 4 * d  # one shared block
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k routed)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full_moe_layer = (
            self.n_experts * 3 * d * self.d_ff_expert
        )
        active_moe_layer = self.moe_top_k * 3 * d * self.d_ff_expert
        n_moe_layers = self.n_layers - self.first_dense_layers
        return self.param_count() - n_moe_layers * (full_moe_layer - active_moe_layer)
