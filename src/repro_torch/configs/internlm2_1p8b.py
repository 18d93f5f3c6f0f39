"""InternLM2-1.8B [arXiv:2403.17297; hf]. Dense GQA decoder."""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92544,
    rope_theta=1e6,
    notes="full attention -> long_500k skipped",
)
