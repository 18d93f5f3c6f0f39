"""Whisper-small [arXiv:2212.04356; unverified].

Enc-dec; the 2x conv1d audio frontend is a STUB per the assignment —
``input_specs`` supplies precomputed frame embeddings (B, S, d_model).
Decoder: causal self-attention + cross-attention over encoder states.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,        # decoder layers
    enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab=51865,
    norm="layer",
    embed_inputs=False,
    enc_frames=1500,
    notes="enc-dec; frontend stubbed; decode shapes use self-cache=seq_len, cross-cache=1500 frames; full attention -> long_500k skipped",
)
