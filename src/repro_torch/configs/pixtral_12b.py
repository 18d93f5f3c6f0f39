"""Pixtral-12B backbone [hf:mistralai/Pixtral-12B-2409; unverified].

VLM: Pixtral-ViT frontend is a STUB per the assignment — ``input_specs``
supplies precomputed patch embeddings (B, S, d_model); this config is the
Mistral-NeMo-style decoder backbone only.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
    embed_inputs=True,
    notes="vlm backbone; patch embeddings from stub frontend; full attention -> long_500k skipped",
)
