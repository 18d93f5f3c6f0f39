"""DeepSeek-7B [arXiv:2401.02954; hf]. LLaMA-architecture dense decoder (MHA)."""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=11008,
    vocab=102400,
    notes="full attention -> long_500k skipped",
)
