"""Mixtral-8x7B [arXiv:2401.04088; hf]. 8-expert top-2 MoE with SWA.

The 4096-token sliding window bounds the decode KV cache (ring buffer),
so long_500k RUNS for this architecture.
"""

from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=32000,
    swa_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(d_model=4096, n_experts=8, top_k=2, d_ff_expert=14336),
    notes="SWA ring cache -> long_500k runs with window=4096",
)
