"""Decoder-only LM: the dense, MoE, SSM (Mamba2) and hybrid (Zamba2)
families (the port's ``repro.models.transformer``).

Two paths: the full-sequence forward (prefill logits, scoring, the eval
loss with the MoE router's auxiliary loss, and the training loss, which
autograd differentiates through the GEMM funnel) and the decode step.
Layer params are stacked along a leading ``L`` axis, as in the reference;
where the reference scans over that axis, the port loops over the layers,
taken out of the cast stack by one ``torch.unbind`` (whose backward is a
single ``stack``).  With ``remat=True`` each layer body runs under
``torch.utils.checkpoint`` and is recomputed in the backward under the
execution context it first ran under.  Decode state is
written in place: dense ``(L, B, S_cache, Hkv, Dh)`` KV lanes or paged
``(L, n_pages, page_size, Hkv, Dh)`` arenas (a sliding window makes them
rings of ``min(window, seq_len)`` slots), or for the Mamba2 families the
recurrent state ``{"mamba": {"ssm", "conv_x", "conv_bc"}}`` (each leaf
``(L, B, ...)``) plus, for the hybrid, the shared attention block's
``shared_k`` / ``shared_v`` rings ``(n_groups, B, S_cache, Hkv, Dh)``.
The hybrid runs ``n_layers // shared_attn_every`` groups of Mamba2 layers,
each followed by one weight-shared attention+GLU block.  With
``cfg.embed_inputs`` the model takes ``batch["embeds"]`` (B, S, D) in
place of tokens.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.core import execution as X
from repro_torch.distributed import collectives as C
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


def attn_config(cfg: ArchConfig, *, causal: bool = True) -> L.AttnConfig:
    return L.AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        window=cfg.swa_window,
        causal=causal,
    )


def block_kind(cfg: ArchConfig) -> str:
    return {"dense": "attn_mlp", "moe": "attn_moe", "ssm": "mamba", "hybrid": "mamba"}[
        cfg.family
    ]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_blocks(generator, cfg: ArchConfig, kind: str, nl: int, *, device, dtype) -> dict:
    """``nl`` stacked blocks of ``kind``: attention + GLU / MoE, or Mamba2."""

    d = cfg.d_model
    ones = lambda *shape: torch.ones(shape, dtype=L.PARAM_DTYPE, device=device)  # noqa: E731
    if kind == "mamba":
        return {"ln": ones(nl, d), "mamba": S.init_mamba2(generator, cfg.ssm, nl, device=device,
                                                          dtype=dtype)}
    acfg = attn_config(cfg)
    hq, hkv = acfg.n_heads * acfg.d_head, acfg.n_kv_heads * acfg.d_head
    stack = lambda shape: L.dense_init(generator, (nl,) + shape, device=device, dtype=dtype)  # noqa: E731
    attn = {"wq": stack((d, hq)), "wk": stack((d, hkv)), "wv": stack((d, hkv)), "wo": stack((hq, d))}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((nl, hq), dtype=L.PARAM_DTYPE, device=device)
        attn["bk"] = torch.zeros((nl, hkv), dtype=L.PARAM_DTYPE, device=device)
        attn["bv"] = torch.zeros((nl, hkv), dtype=L.PARAM_DTYPE, device=device)
    blocks = {"ln1": ones(nl, d), "attn": attn, "ln2": ones(nl, d)}
    if kind == "attn_moe":
        blocks["moe"] = M.init_moe(generator, cfg.moe, nl, device=device, dtype=dtype)
    else:
        blocks["mlp"] = {
            "w1": stack((d, cfg.d_ff)),
            "w3": stack((d, cfg.d_ff)),
            "w2": stack((cfg.d_ff, d)),
        }
    return blocks


def init_lm(generator: torch.Generator, cfg: ArchConfig, *, device,
            dtype: torch.dtype = L.COMPUTE_DTYPE) -> dict[str, Any]:
    """Random params at the reference's scales: projections ``dense_init``
    (normal / sqrt(fan_in)), ``lm_head`` and ``embed`` 0.02, norms ones.
    Projections, ``embed`` and ``lm_head`` are stored in ``dtype``; norms
    (and the Mamba2 block's conv, rate and gate params) stay fp32.  An MoE
    block carries ``"moe"`` params (router, experts, shared expert) in place
    of the dense ``"mlp"``; a Mamba2 block ``"ln"`` and ``"mamba"``.  The
    hybrid adds one unstacked attention+GLU block, ``"shared"``; embedding
    inputs drop ``"embed"``."""

    d = cfg.d_model
    params = {
        "blocks": _init_blocks(generator, cfg, block_kind(cfg), cfg.n_layers, device=device,
                               dtype=dtype),
        "final_norm": torch.ones((d,), dtype=L.PARAM_DTYPE, device=device),
        "lm_head": L.dense_init(generator, (d, cfg.vocab), scale=0.02, device=device, dtype=dtype),
    }
    if not cfg.embed_inputs:
        params["embed"] = L.embed_init(generator, (cfg.vocab, d), device=device, dtype=dtype)
    if cfg.shared_attn_every:
        shared = _init_blocks(generator, cfg, "attn_mlp", 1, device=device, dtype=dtype)
        params["shared"] = layer_params(shared, 0)
    return params


def n_groups(cfg: ArchConfig) -> int:
    """The hybrid's groups: Mamba2 layers ``[g·every, (g+1)·every)`` and
    then the shared block, for ``g < n_layers // every`` (0 otherwise)."""

    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


def gemm_shapes(cfg: ArchConfig) -> list:
    """``((K, N), calls)`` of every ``ops.gemm`` of one decode step (or one
    forward): q, k and v, o, then the dense GLU's gate, up and down or the
    MoE shared expert's (the router, the shared gate and the routed
    experts are not ``ops.gemm`` calls), then the LM head.  A Mamba2 block
    makes none (its projections are plain products); the hybrid's shared
    block makes its seven once a group."""

    d, hq = cfg.d_model, cfg.n_heads * cfg.head_dim
    hkv, kind = cfg.n_kv_heads * cfg.head_dim, block_kind(cfg)
    n_attn = n_groups(cfg) if kind == "mamba" else cfg.n_layers
    ff = cfg.moe.d_ff_shared if kind == "attn_moe" else cfg.d_ff
    shapes = []
    if n_attn:
        shapes = [((d, hq), n_attn), ((d, hkv), 2 * n_attn), ((hq, d), n_attn)]
        if ff:
            shapes += [((d, ff), 2 * n_attn), ((ff, d), n_attn)]
    return shapes + [((d, cfg.vocab), 1)]


def layer_params(blocks, i: int):
    """Layer ``i``'s params: views into the stacked tensors."""

    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


# ---------------------------------------------------------------------------
# Forward (prefill / scoring / eval)
# ---------------------------------------------------------------------------


def _ffn(p, x, cfg: ArchConfig):
    """The block's second half on the normed stream: the dense GLU (no
    auxiliary loss) or the MoE layer and its router loss."""

    if "moe" in p:
        return M.apply_moe(p["moe"], x, cfg.moe)
    return L.apply_glu(p["mlp"], x), 0.0


def _apply_attn_block(p, x, cfg: ArchConfig, positions, *, attn_backend: str = "auto"):
    h, kv = L.apply_attention(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), attn_config(cfg),
                              positions=positions, backend=attn_backend)
    x = x + h
    h, aux = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + h, aux, kv


def _layer_fn(cfg: ArchConfig, kind: str, positions, *, attn_backend: str = "auto"):
    """One layer's body, ``(x, p) -> (x, aux)``; a dense or Mamba2 block's
    aux is 0."""

    def f(x, p):
        if kind == "mamba":
            h, _ = S.apply_mamba2(p["mamba"], L.rms_norm(x, p["ln"], cfg.norm_eps), cfg.ssm)
            return x + h, 0.0
        if kind not in ("attn_mlp", "attn_moe"):
            raise ValueError(kind)
        x, aux, _ = _apply_attn_block(p, x, cfg, positions, attn_backend=attn_backend)
        return x, aux

    return f


def _cast_params(tree):
    """The reference's compute cast: every fp32 leaf to bf16 (norm weights,
    qkv biases and the Mamba2 block's fp32 params too), as its forward does
    before the layers run."""

    if isinstance(tree, dict):
        return {k: _cast_params(v) for k, v in tree.items()}
    return tree.to(L.COMPUTE_DTYPE) if tree.dtype == torch.float32 else tree


def _unstack(blocks, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf split by one
    ``torch.unbind`` (indexing a stack per layer would give every layer's
    backward a zero tensor the size of the whole stack)."""

    if isinstance(blocks, dict):
        per_key = {k: _unstack(v, n) for k, v in blocks.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(blocks, 0))


def _remat(fn):
    """``fn`` under ``torch.utils.checkpoint``: its activations are dropped
    and recomputed in the backward, under the execution context active
    now (the recompute runs on autograd's thread, which does not see this
    one's ``ContextVar``)."""

    ctx = X.current_context()

    def context_fn():
        return contextlib.nullcontext(), (ctx if ctx is not None else contextlib.nullcontext())

    def f(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=context_fn)

    return f


def forward_lm(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto",
               remat: bool = False):
    """Returns ``(logits (B, S, V) bf16, aux_loss)``; ``batch["tokens"]``
    is (B, S) (``batch["embeds"]`` (B, S, D) with ``cfg.embed_inputs``).
    ``aux_loss`` is the fp32 sum of the layers' MoE router losses (0 for
    the other families).  ``attn_backend`` names the attention route (an
    ``execution.BACKENDS`` entry of the ``flash_attn`` family).  ``params``
    may be fp32 masters (cast to bf16 once here) or stored in bf16;
    ``remat`` recomputes each layer body (and the hybrid's shared block) in
    the backward, the LM head excepted, as the reference's
    ``jax.checkpoint`` does."""

    x = embed_tokens(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    body = _layer_fn(cfg, block_kind(cfg), positions, attn_backend=attn_backend)
    layers = _unstack(_cast_params(params["blocks"]), cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    every = cfg.shared_attn_every
    if every:  # Zamba2: groups of `every` Mamba2 layers + the shared block
        shared = _cast_params(params["shared"])
        shared_fn = lambda xx: _apply_attn_block(shared, xx, cfg, positions,  # noqa: E731
                                                 attn_backend=attn_backend)[0]
        if remat:
            body, shared_fn = _remat(body), _remat(shared_fn)
        for g in range(n_groups(cfg)):
            for i in range(g * every, (g + 1) * every):
                x, _ = body(x, layers[i])
            x = shared_fn(x)
    else:
        if remat:
            body = _remat(body)
        for i in range(cfg.n_layers):
            x, aux_i = body(x, layers[i])
            aux = aux + aux_i
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ops.gemm(x, params["lm_head"].to(L.COMPUTE_DTYPE))
    return logits, aux


def cross_entropy(logits, labels, mask=None):
    """Mean softmax cross-entropy in fp32 over (B, S, V) logits.

    The reference sums ``shifted * one_hot(labels)`` so that the vocab axis
    stays sharded; on one card a gather reads the same element (every other
    term of that sum is an exact zero) without a (B, S, V) one-hot.  The
    row max is a constant to the gradient, as the reference's
    ``stop_gradient`` makes it.
    """

    lf = logits.float()
    shifted = lf - lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    ll = shifted.gather(-1, labels.long()[..., None])[..., 0] - lse
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto", remat: bool = False):
    """``(loss, {"ce", "aux"})`` on ``batch["tokens"]`` (or ``"embeds"``) against
    ``batch["labels"]`` (optionally weighted by ``batch["mask"]``)."""

    logits, aux = forward_lm(params, cfg, batch, attn_backend=attn_backend, remat=remat)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto"):
    """Full-sequence inference forward; returns the logits."""

    logits, _ = forward_lm(params, cfg, batch, attn_backend=attn_backend)
    return logits


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.swa_window is not None:
        return min(cfg.swa_window, seq_len)
    return seq_len


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *, device):
    """Dense per-slot decode state, the slot (batch) dim of every leaf at 1.

    Attention families: KV lanes ``(L, B, S_cache, Hkv, Dh)`` in bf16
    (``S_cache`` is :func:`cache_len`: a ring of the window's size).
    Mamba2: ``{"mamba": {"ssm" (L, B, H, N, P) fp32, "conv_x", "conv_bc"
    (L, B, d_conv - 1, C) bf16}}``.  The hybrid adds ``shared_k`` /
    ``shared_v`` ``(n_groups, B, min(seq_len, 32768), Hkv, Dh)``: the
    shared block's cache, capped at a practical window."""

    nl = cfg.n_layers
    if block_kind(cfg) == "mamba":
        st = S.init_mamba2_state(batch, cfg.ssm, device=device)
        state = {"mamba": {k: torch.zeros((nl,) + tuple(v.shape), dtype=v.dtype, device=device)
                           for k, v in st.items()}}
    else:
        kv_shape = (nl, batch, cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.head_dim)
        state = {
            "k": torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device),
            "v": torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device),
        }
    if cfg.shared_attn_every:
        kv_shape = (n_groups(cfg), batch, min(seq_len, 32768), cfg.n_kv_heads, cfg.head_dim)
        state["shared_k"] = torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device)
        state["shared_v"] = torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device)
    return state


def init_decode_state_paged(cfg: ArchConfig, n_pages: int, page_size: int, *, device):
    """Paged decode cache: one shared page arena per layer, no batch dim.
    Only the pure KV-cache families page."""

    if block_kind(cfg) == "mamba" or cfg.shared_attn_every:
        raise ValueError(
            f"paged KV state requires a pure KV-cache family, not "
            f"{cfg.family!r} (recurrent state has no pages to allocate)"
        )
    kv_shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "pages_k": torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device),
        "pages_v": torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device),
    }


def embed_tokens(params, cfg: ArchConfig, batch):
    if cfg.embed_inputs:
        return batch["embeds"].to(L.COMPUTE_DTYPE)
    return params["embed"][batch["tokens"].long()].to(L.COMPUTE_DTYPE)


def _write_plan(acfg: L.AttnConfig, state, batch, pos, b: int, device):
    """Where a step's new K/V land, one plan for every layer of the step."""

    if "pages_k" in state:
        n_pages, page_size = state["pages_k"].shape[1:3]
        return L.paged_write_plan(batch["page_table"], pos, page_size, n_pages, acfg)
    return L.dense_write_plan(pos, b, state["k"].shape[2], acfg, device)


def _decode_attn_block(p, x, cfg: ArchConfig, acfg: L.AttnConfig, state, i: int, batch, pos,
                       live, plan=None):
    """Layer ``i``'s attention block on one token, its dense or paged
    cache written in place (at ``plan``'s targets, when given)."""

    h_in = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if "pages_k" in state:
        h, _ = L.decode_attention_paged(
            p["attn"], h_in, acfg, state["pages_k"][i], state["pages_v"][i],
            batch["page_table"], pos, live=live, plan=plan,
        )
    else:
        h, _ = L.decode_attention(p["attn"], h_in, acfg, state["k"][i], state["v"][i], pos,
                                  live=live, plan=plan)
    x = x + h
    return x + _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)[0]


def _decode_mamba(params, cfg: ArchConfig, x, state, pos):
    """The Mamba2 layers on one token, and for the hybrid the shared block
    after each group (its cache a ring of its own length, no ``live``
    mask, as in the reference)."""

    every = cfg.shared_attn_every
    n_run = n_groups(cfg) * every if every else cfg.n_layers
    if every:
        sc = state["shared_k"].shape[2]
        shared_cfg = dataclasses.replace(attn_config(cfg), window=sc if sc < 524288 else None)
        shared_state = {"k": state["shared_k"], "v": state["shared_v"]}
    for i in range(n_run):
        p = layer_params(params["blocks"], i)
        h, _ = S.decode_mamba2(p["mamba"], L.rms_norm(x, p["ln"], cfg.norm_eps), cfg.ssm,
                               layer_params(state["mamba"], i))
        x = x + h
        if every and (i + 1) % every == 0:
            x = _decode_attn_block(params["shared"], x, cfg, shared_cfg, shared_state,
                                   i // every, None, pos, None)
    return x


def decode_step(params, cfg: ArchConfig, batch, state, pos):
    """One-token serve step; the state in ``state`` is written in place.

    batch: ``{"tokens": (B, 1)}`` (``{"embeds": (B, 1, D)}`` with
    ``cfg.embed_inputs``) plus optionally ``"page_table"`` (B, W) int32 —
    required when ``state`` is the paged arena — and ``"live"`` (B,) bool
    (attention layers only; the Mamba2 recurrence takes no mask).  pos: a
    scalar or a (B,) vector of absolute positions.  Returns ``(logits (B,
    1, V) bf16, state)``.  An MoE layer routes the batch's rows as one
    merged group (``moe.apply_moe``), so rows of an MoE step are coupled
    through the experts' capacity.
    """

    x = embed_tokens(params, cfg, batch)
    if block_kind(cfg) == "mamba":
        x = _decode_mamba(params, cfg, x, state, pos)
    else:
        live = batch.get("live")
        acfg = attn_config(cfg)
        plan = _write_plan(acfg, state, batch, pos, x.shape[0], x.device)
        for i in range(cfg.n_layers):
            x = _decode_attn_block(layer_params(params["blocks"], i), x, cfg, acfg, state, i,
                                   batch, pos, live, plan)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ops.gemm(x, params["lm_head"].to(L.COMPUTE_DTYPE))
    return logits, state


# ---------------------------------------------------------------------------
# The dense family on a (data, model) mesh: a rank's part
# ---------------------------------------------------------------------------
#
# ``lay`` (``distributed.spmd.Layout``) holds the mesh, the params' spec
# tree and ``seq_shard``; ``params`` hold this rank's shards.  Where the
# reference pins an activation with ``constrain_batch`` (the embedding's
# output, each sub-block's output, the residual carry at each layer, the
# logits), the residual stream here *is* in that layout: its rows this
# rank's share of the batch over the dp axes, its sequence split over
# ``model`` under ``seq_shard`` (else whole), the logits' vocab over
# ``model``.


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: the {cfg.family} family on a sharded mesh is slice 14's "
                         "(only the dense family runs sharded)")


def _seq_local(x, lay, seq: bool):
    """This rank's share of a replicated (B, S, ...) tensor's sequence."""

    if not seq:
        return x
    c = x.shape[1] // lay.model
    return x.narrow(1, lay.model_index * c, c)


def embed_tokens_sharded(params, cfg: ArchConfig, batch, lay, *, seq: bool):
    """The vocab-parallel embedding: each rank looks up the token ids in
    its rows of ``embed`` (``P("model", None)``), the others give zeros,
    and the partial rows are all-reduced over ``model`` (reduce-scattered
    along the sequence under ``seq``).  Embedding inputs are sliced."""

    if cfg.embed_inputs:
        return _seq_local(batch["embeds"].to(L.COMPUTE_DTYPE), lay, seq)
    emb, spec = params["embed"], lay.specs["embed"]
    spmd.require_model(spec, "embed", lay, 0)
    ids = batch["tokens"].long()
    if lay.model == 1:
        return _seq_local(emb[ids].to(L.COMPUTE_DTYPE), lay, seq)
    v_loc = emb.shape[0]
    local = ids - lay.model_index * v_loc
    ok = (local >= 0) & (local < v_loc)
    x = emb[torch.clamp(local, 0, v_loc - 1)].to(L.COMPUTE_DTYPE)
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    if seq:
        return C.scatter(x, lay.mesh, "model", 1)
    return C.reduce(x, lay.mesh, "model")


def _attn_block_sharded(p, sp, x, cfg: ArchConfig, lay, positions, seq: bool, attn_backend):
    acfg = attn_config(cfg)
    h = L.apply_attention_tp(p["attn"], sp["attn"],
                             L.rms_norm(x, spmd.norm_weight(p["ln1"], lay, seq), cfg.norm_eps),
                             acfg, lay, positions=positions, seq=seq, backend=attn_backend)
    x = x + h
    h = L.apply_glu_tp(p["mlp"], sp["mlp"],
                       L.rms_norm(x, spmd.norm_weight(p["ln2"], lay, seq), cfg.norm_eps),
                       lay, seq=seq)
    return x + h


def forward_lm_sharded(params, cfg: ArchConfig, batch, lay, *, attn_backend: str = "auto",
                       remat: bool = False):
    """:func:`forward_lm` on a mesh: returns ``(logits, aux)``, the logits
    this rank's rows (B_local, S, V / model), their vocab split over
    ``model`` as the reference's ``constrain_batch(logits, extra=("model",))``
    pins them; ``aux`` 0 (the dense family).  Each layer's FSDP gathers run
    inside its body, so ``remat`` gathers again in the backward."""

    _require_dense(cfg)
    b, s = (batch["embeds"] if cfg.embed_inputs else batch["tokens"]).shape[:2]
    seq = lay.seq_sharded((b, s, cfg.d_model))
    x = embed_tokens_sharded(params, cfg, batch, lay, seq=seq)
    positions = torch.arange(s, device=x.device)[None, :]
    specs = spmd.layer_specs(lay.specs["blocks"])

    def body(x, p):
        return _attn_block_sharded(p, specs, x, cfg, lay, positions, seq, attn_backend)

    if remat:
        body = _remat(body)
    layers = _unstack(_cast_params(params["blocks"]), cfg.n_layers)
    for i in range(cfg.n_layers):
        x = body(x, layers[i])
    x = L.rms_norm(x, spmd.norm_weight(params["final_norm"], lay, seq), cfg.norm_eps)
    x = spmd.tp_enter(x, lay, seq)
    spmd.require_model(lay.specs["lm_head"], "lm_head", lay, 1)
    logits = spmd.row(x, params["lm_head"].to(L.COMPUTE_DTYPE), lay.specs["lm_head"], lay)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def cross_entropy_sharded(logits, labels, lay, mask=None):
    """The vocab-parallel cross-entropy of this rank's rows: the row max,
    the sum of exponentials and the target's logit each reduced over
    ``model``; the sum over this rank's tokens divided by the *global*
    token count (the dp ranks' counts all-reduced), so that the dp ranks'
    terms add up to the reference's mean (``spmd.dp_sum``)."""

    lf = logits.float()
    mx = C.all_reduce(lf.amax(dim=-1).detach(), lay.mesh, "model", op="max")
    shifted = lf - mx[..., None]
    lse = torch.log(C.reduce(torch.exp(shifted).sum(dim=-1), lay.mesh, "model"))
    v_loc = lf.shape[-1]
    local = labels.long() - lay.model_index * v_loc
    ok = (local >= 0) & (local < v_loc)
    tgt = shifted.gather(-1, torch.clamp(local, 0, v_loc - 1)[..., None])[..., 0]
    tgt = C.reduce(torch.where(ok, tgt, torch.zeros((), device=tgt.device)), lay.mesh, "model")
    ll = tgt - lse
    if mask is None:
        num, count = ll.sum(), torch.tensor(float(ll.numel()), device=ll.device)
    else:
        mask = mask.float()
        num, count = (ll * mask).sum(), mask.sum()
    count = C.all_reduce(count.detach(), lay.mesh, lay.dp)
    return -num / torch.clamp(count, min=1.0)


def loss_fn_sharded(params, cfg: ArchConfig, batch, lay, *, attn_backend: str = "auto",
                    remat: bool = False):
    """``(loss, {"ce", "aux"})`` of this rank's rows: its term of the global
    mean (``spmd.dp_sum`` over the dp ranks gives the reference's loss)."""

    logits, aux = forward_lm_sharded(params, cfg, batch, lay, attn_backend=attn_backend,
                                     remat=remat)
    ce = cross_entropy_sharded(logits, batch["labels"], lay, batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def decode_step_sharded(params, cfg: ArchConfig, batch, state, pos, lay, cache_spec):
    """:func:`decode_step` on a mesh: this rank's rows, its slice of each
    cache's length (``cache_spec``, the caches' ``sharding.cache_pspec``),
    the logits' vocab over ``model``; dense caches only (the reference
    never runs the paged engine on a data/model mesh)."""

    _require_dense(cfg)
    if "pages_k" in state:
        raise ValueError("the paged arena is not sharded over a data/model mesh")
    x = embed_tokens_sharded(params, cfg, batch, lay, seq=False)
    b = x.shape[0]
    acfg = attn_config(cfg)
    if cache_spec[2] is not None and cache_spec[2] != ("model",):
        raise ValueError(f"a cache length split over {cache_spec[2]!r} (a batch the dp axes "
                         "cannot split) is slice 14's")
    split = cache_spec[2] == ("model",)
    s_local = state["k"].shape[2]
    s_total = s_local * (lay.model if split else 1)
    plan = L.cache_split_plan(pos, b, s_local, lay, split, x.device)
    specs = spmd.layer_specs(lay.specs["blocks"])
    live = batch.get("live")
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        h = L.decode_attention_tp(p["attn"], specs["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                                  acfg, lay, state["k"][i], state["v"][i], pos, plan=plan,
                                  s_total=s_total, split=split, live=live)
        x = x + h
        x = x + L.apply_glu_tp(p["mlp"], specs["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps),
                               lay, seq=False)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = spmd.row(x, params["lm_head"].to(L.COMPUTE_DTYPE), lay.specs["lm_head"], lay)
    return logits, state


__all__ = [
    "attn_config",
    "block_kind",
    "cache_len",
    "cross_entropy",
    "cross_entropy_sharded",
    "decode_step_sharded",
    "embed_tokens_sharded",
    "forward_lm_sharded",
    "loss_fn_sharded",
    "decode_step",
    "embed_tokens",
    "forward_lm",
    "gemm_shapes",
    "init_decode_state",
    "init_decode_state_paged",
    "init_lm",
    "layer_params",
    "loss_fn",
    "n_groups",
    "prefill",
]
