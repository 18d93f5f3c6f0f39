"""Qwen2-MoE-A2.7B (Qwen1.5-MoE-A2.7B) [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 routed experts top-4 + 4 shared experts (4 x 1408 = 5632 aggregated
shared width, implemented as a single gated GLU of width 5632 —
mathematically identical to four parallel 1408 experts always active).
"""

from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(d_model=2048, n_experts=60, top_k=4, d_ff_expert=1408,
                  d_ff_shared=5632, rs_output=False),
    notes="full attention -> long_500k skipped",
)
