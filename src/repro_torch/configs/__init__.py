"""Architecture configuration registry (the port's ``repro.configs``).

One module per architecture (``src/repro_torch/configs/<id>.py``), each
exporting ``CONFIG: ArchConfig`` with the exact published dimensions.
``get_config(name)`` resolves either the registry id (e.g.
``"internlm2-1.8b"``) or the module name (``"internlm2_1p8b"``).

Every config also knows how to produce a *reduced* variant
(:meth:`ArchConfig.reduced`) for the CPU smoke tests — same family and
block structure, tiny dims.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

# Copies of the reference's MoE/SSM config records, so that every
# ArchConfig field keeps its type.  ``MoEConfig`` drives the port's MoE
# family (``repro_torch.models.moe``), ``SSMConfig`` its Mamba2 blocks
# (``repro_torch.models.ssm``).


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    d_ff_shared: int = 0          # aggregated shared-expert width (Qwen2-MoE)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Reduce-scatter the expert output buffer over "model" (wins 4× on
    # wide-expert MoE like Mixtral; measured to HURT fine-grained-expert
    # MoE, whose weights are FSDP-only — see EXPERIMENTS.md §Perf C).
    rs_output: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    # The published initialisation of mamba_ssm's Mamba2 module [arXiv:2405.21060]:
    # A = -U(A_init_range), dt = exp(U(log dt_min, log dt_max)) floored at
    # dt_init_floor and stored as its inverse softplus, D = 1, the conv
    # PyTorch's default.  None keeps the reference's constants (A_log 0,
    # dt_bias 0).
    A_init_range: Optional[tuple] = None
    dt_min: Optional[float] = None
    dt_max: Optional[float] = None
    dt_init_floor: Optional[float] = None

    @property
    def published_init(self) -> bool:
        return self.A_init_range is not None

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned LM shape set (identical across the ten architectures).
LM_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qkv_bias: bool = False
    swa_window: Optional[int] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm: str = "rms"           # rms | layer
    embed_inputs: bool = False  # pixtral: backbone consumes patch embeddings
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0  # zamba2: shared attn+mlp block cadence
    enc_layers: int = 0         # whisper: encoder depth (decoder = n_layers)
    enc_frames: int = 1500      # whisper: cross-attention KV length at decode
    # The output head is the embedding's transpose: no ``lm_head`` leaf.
    tie_embeddings: bool = False
    # mamba_ssm's published precision: the residual stream between layers
    # in fp32, and the Mamba2 block's ``A_log``, ``dt_bias`` and ``D`` into
    # the scan in fp32 (its params stay fp32; only products take bf16).
    residual_in_fp32: bool = False
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: SSM state / hybrid / sliding window."""

        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    def shapes(self, include_skipped: bool = False):
        out = []
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.subquadratic and not include_skipped:
                continue
            out.append(s)
        return out

    def param_count(self) -> int:
        """Analytic total parameter count (used by MODEL_FLOPS)."""

        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        glu = 3 * d * f
        n = 0
        if not self.embed_inputs:
            n += v * d
        if not self.tie_embeddings:
            n += d * v  # lm head
        if self.family == "dense":
            n += L * (attn + glu + 2 * d)
        elif self.family == "moe":
            m = self.moe
            per = attn + 2 * d + d * m.n_experts + 3 * m.n_experts * d * m.d_ff_expert
            if m.d_ff_shared:
                per += 3 * d * m.d_ff_shared + d
            n += L * per
        elif self.family == "ssm":
            n += L * self._mamba_params()
        elif self.family == "hybrid":
            n += L * self._mamba_params()
            n += attn + glu + 2 * d  # one shared block
        elif self.family == "encdec":
            mlp = 2 * d * f
            n += self.enc_layers * (attn + mlp + 2 * d)
            n += L * (attn + (d * hkv * 2 + d * hq + hq * d) + mlp + 3 * d)
        return n

    def _mamba_params(self) -> int:
        s = self.ssm
        di = s.d_inner
        gn2 = 2 * s.n_groups * s.d_state
        return (
            2 * self.d_model * di          # wz, wx
            + self.d_model * gn2           # wbc
            + self.d_model * s.n_heads     # wdt
            + s.d_conv * (di + gn2)        # convs
            + 3 * s.n_heads + di           # dt_bias, A_log, D, norm
            + di * self.d_model            # out_proj
        )

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k only)."""

        if self.family != "moe":
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.n_layers
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        per = attn + 2 * d + d * m.n_experts + 3 * m.top_k * d * m.d_ff_expert
        if m.d_ff_shared:
            per += 3 * d * m.d_ff_shared + d
        return self.vocab * d * 2 + L * per

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""

        kw = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            d_head=16,
            qkv_bias=self.qkv_bias,
            swa_window=8 if self.swa_window else None,
            embed_inputs=self.embed_inputs,
            norm=self.norm,
            shared_attn_every=2 if self.shared_attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_frames=16,
            tie_embeddings=self.tie_embeddings,
            residual_in_fp32=self.residual_in_fp32,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                d_model=64,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=32,
                d_ff_shared=64 if self.moe.d_ff_shared else 0,
            )
        if self.ssm is not None:
            s = self.ssm
            kw["ssm"] = SSMConfig(d_model=64, d_state=16, headdim=16, expand=2, chunk=8,
                                  A_init_range=s.A_init_range, dt_min=s.dt_min, dt_max=s.dt_max,
                                  dt_init_floor=s.dt_init_floor)
        return ArchConfig(**kw)


# The fields the port's records add to the reference's, and the value each
# holds in every config mirrored from the reference.
PORT_FIELDS = {"tie_embeddings": False, "residual_in_fp32": False, "A_init_range": None,
               "dt_min": None, "dt_max": None, "dt_init_floor": None}


def reference_fields(fields: dict) -> dict:
    """A record's fields (``vars`` or ``dataclasses.asdict`` of an
    ``ArchConfig`` or ``SSMConfig``) without the port's own, each of which
    must hold its mirrored value: what the reference's record holds."""

    moved = {k: v for k, v in fields.items() if k in PORT_FIELDS and v != PORT_FIELDS[k]}
    if moved:
        raise ValueError(f"not a mirrored config: {moved}")
    return {k: v for k, v in fields.items() if k not in PORT_FIELDS}


# The reference's ten architectures (one module per id under
# ``repro_torch/configs``).
_REGISTRY = {
    "internlm2-1.8b": "internlm2_1p8b",
    "qwen2.5-32b": "qwen2p5_32b",
    "minitron-4b": "minitron_4b",
    "deepseek-7b": "deepseek_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "mamba2-1.3b": "mamba2_1p3b",
    "zamba2-2.7b": "zamba2_2p7b",
    "whisper-small": "whisper_small",
    "pixtral-12b": "pixtral_12b",
}


# Configs the port runs beside the reference's ten; ``list_configs`` (the
# ten every parity test walks) leaves them out.
_PORT_ONLY = {
    "mamba2-1.3b-published": "mamba2_1p3b_published",
}


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    mod_name = _REGISTRY.get(name) or _PORT_ONLY.get(name) or name.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


__all__ = ["ArchConfig", "MoEConfig", "PORT_FIELDS", "SSMConfig", "ShapeSpec", "LM_SHAPES",
           "get_config", "list_configs", "reference_fields"]
