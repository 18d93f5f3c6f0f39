"""Mamba2-1.3B as published [arXiv:2405.21060; huggingface.co/state-spaces/mamba2-1.3b].

The model card's ``config.json``: d_model 2048, 48 layers, vocab_size
50,277 padded to a multiple of 16 (50,288 rows held), a tied output head,
the residual stream in fp32, RMSNorm.  The Mamba2 module keeps mamba_ssm's
defaults (d_state 128, headdim 64, expand 2, one group, d_conv 4, chunk
256) and its initialisation (A in [1, 16], dt in [0.001, 0.1] floored at
1e-4); ``out_proj`` is rescaled by 1/sqrt(48) (``rescale_prenorm_residual``).

``mamba2-1.3b`` stays the reference's variant (an untied head, a bf16
residual, 50,280 rows, A_log = dt_bias = 0), which the parity tests hold
the port to.
"""

from repro_torch.configs import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b-published",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_head=64,
    d_ff=0,
    vocab=50288,
    ssm=SSMConfig(d_model=2048, d_state=128, headdim=64, expand=2, chunk=256,
                  A_init_range=(1.0, 16.0), dt_min=0.001, dt_max=0.1, dt_init_floor=1e-4),
    tie_embeddings=True,
    residual_in_fp32=True,
    notes="the published model: tied head, fp32 residual, 50,277 ids padded to 50,288 rows",
)
