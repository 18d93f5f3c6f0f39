"""Qwen2.5-32B [hf:Qwen/Qwen2.5-32B; hf]. Dense GQA decoder with QKV bias."""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    notes="full attention -> long_500k skipped",
)
