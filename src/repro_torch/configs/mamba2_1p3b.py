"""Mamba2-1.3B [arXiv:2405.21060; unverified]. Attention-free SSD."""

from repro_torch.configs import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_head=64,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_model=2048, d_state=128, headdim=64, expand=2, chunk=256),
    notes="attention-free -> long_500k runs (constant-size recurrent state); no decode KV cache",
)
