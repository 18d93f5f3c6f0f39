"""Zamba2-2.7B [arXiv:2411.15242; hf].

Hybrid: Mamba2 backbone with a weight-shared attention+MLP block applied
every 6 layers (the paper's shared-block design, simplified to a single
shared set without the LoRA adapters; see DESIGN.md).
"""

from repro_torch.configs import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(d_model=2560, d_state=64, headdim=64, expand=2, chunk=256),
    shared_attn_every=6,
    notes="ssm hybrid -> long_500k runs (constant-size recurrent state + shared attn over window)",
)
