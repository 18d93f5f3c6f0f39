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
place of tokens.  With ``cfg.tie_embeddings`` the head is ``embed``ᵀ
(no ``lm_head``; one card only), with ``cfg.residual_in_fp32`` the
residual stream is fp32 between the layers.
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
from repro_torch.distributed import sharding as SH
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
    inputs drop ``"embed"``, a tied head (``cfg.tie_embeddings``)
    ``"lm_head"``."""

    d = cfg.d_model
    params = {
        "blocks": _init_blocks(generator, cfg, block_kind(cfg), cfg.n_layers, device=device,
                               dtype=dtype),
        "final_norm": torch.ones((d,), dtype=L.PARAM_DTYPE, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, (d, cfg.vocab), scale=0.02, device=device,
                                         dtype=dtype)
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


def _cast_params(tree, keep=frozenset()):
    """The reference's compute cast: every fp32 leaf to bf16 (norm weights,
    qkv biases and the Mamba2 block's fp32 params too), as its forward does
    before the layers run; the leaves named in ``keep`` stay as they are."""

    if isinstance(tree, dict):
        return {k: v if k in keep else _cast_params(v, keep) for k, v in tree.items()}
    return tree.to(L.COMPUTE_DTYPE) if tree.dtype == torch.float32 else tree


def _fp32_leaves(cfg: ArchConfig):
    """The block leaves the forward reads uncast: under ``residual_in_fp32``
    the Mamba2 block's rate and skip vectors."""

    return S.FP32_LEAVES if cfg.residual_in_fp32 else frozenset()


def tied_head(params, x):
    """The tied output projection through the GEMM funnel: ``x · embedᵀ``."""

    return ops.gemm(x, params["embed"].T.to(L.COMPUTE_DTYPE))


def _head(params, cfg: ArchConfig, x):
    """The LM head on the final-normed stream (bf16 operands)."""

    x = x.to(L.COMPUTE_DTYPE)
    if cfg.tie_embeddings:
        return tied_head(params, x)
    return ops.gemm(x, params["lm_head"].to(L.COMPUTE_DTYPE))


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
    one's ``ContextVar``) and with ``layers.RECOMPUTING`` set."""

    ctx = X.current_context()

    def context_fn():
        return contextlib.nullcontext(), L.recomputing(ctx)

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

    x, aux = hidden_lm(params, cfg, batch, attn_backend=attn_backend, remat=remat)
    return _head(params, cfg, x), aux


def hidden_lm(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto",
              remat: bool = False):
    """:func:`forward_lm` up to its head: ``(the final-normed stream (B,
    S, D), aux_loss)``, fp32 under ``cfg.residual_in_fp32``, else bf16."""

    x = embed_tokens(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    body = _layer_fn(cfg, block_kind(cfg), positions, attn_backend=attn_backend)
    layers = _unstack(_cast_params(params["blocks"], _fp32_leaves(cfg)), cfg.n_layers)
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
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


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
    """The residual stream's start: bf16, or fp32 under ``residual_in_fp32``."""

    dt = torch.float32 if cfg.residual_in_fp32 else L.COMPUTE_DTYPE
    if cfg.embed_inputs:
        return batch["embeds"].to(dt)
    return params["embed"][batch["tokens"].long()].to(dt)


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
    return _head(params, cfg, x), state


# ---------------------------------------------------------------------------
# Every family on a (data, model) mesh: a rank's part
# ---------------------------------------------------------------------------
#
# ``lay`` (``distributed.spmd.Layout``) holds the mesh, the params' spec
# tree and ``seq_shard``; ``params`` hold this rank's shards.  Where the
# reference pins an activation with ``constrain_batch`` (the embedding's
# output, each sub-block's output, the residual carry at each layer, the
# logits), the residual stream here *is* in that layout: its rows this
# rank's share of the batch over the dp axes, its sequence split over
# ``model`` under ``seq_shard`` (else whole; a Mamba2 family's always
# whole, as the reference's ``allow_seq=(kind != "mamba")`` keeps it),
# the logits' vocab over ``model`` where the vocab splits (whisper's
# 51,865 does not: its logits are whole, as its ``constrain_batch`` drops
# the indivisible axis).


def _seq_local(x, lay, seq: bool):
    """This rank's share of a replicated (B, S, ...) tensor's sequence."""

    if not seq:
        return x
    c = x.shape[1] // lay.model
    return x.narrow(1, lay.model_index * c, c)


def stream_seq(cfg: ArchConfig, lay, b: int, s: int) -> bool:
    """Is the residual stream of ``b`` rows of ``s`` positions
    sequence-sharded over ``model``?"""

    return block_kind(cfg) != "mamba" and lay.seq_sharded((b, s, cfg.d_model))


def vocab_split(lay, spec, dim: int) -> bool:
    """Does the vocab dim ``dim`` of ``spec`` split over ``model``?"""

    return lay.model > 1 and spmd.splits_model(spec, dim)


def embed_tokens_sharded(params, cfg: ArchConfig, batch, lay, *, seq: bool):
    """The vocab-parallel embedding: each rank looks up the token ids in
    its rows of ``embed`` (``P("model", None)``), the others give zeros,
    and the partial rows are all-reduced over ``model`` (reduce-scattered
    along the sequence under ``seq``).  A vocab ``model`` does not divide
    is replicated: each rank looks up its own positions.  Embedding inputs
    are sliced."""

    if cfg.embed_inputs:
        return _seq_local(batch["embeds"].to(L.COMPUTE_DTYPE), lay, seq)
    emb, spec = params["embed"], lay.specs["embed"]
    ids = batch["tokens"].long()
    if not vocab_split(lay, spec, 0):
        # Under seq each model rank reads its positions: the gradient is partial.
        emb = spmd.norm_weight(emb, lay, seq)
        return emb[_seq_local(ids, lay, seq)].to(L.COMPUTE_DTYPE)
    v_loc = emb.shape[0]
    local = ids - lay.model_index * v_loc
    ok = (local >= 0) & (local < v_loc)
    x = emb[torch.clamp(local, 0, v_loc - 1)].to(L.COMPUTE_DTYPE)
    x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    if seq:
        return C.scatter(x, lay.mesh, "model", 1)
    return C.reduce(x, lay.mesh, "model")


def lm_head_sharded(x, w, spec, lay, seq: bool):
    """The LM head on the residual stream: vocab-parallel (every position,
    this rank's vocab) where ``spec`` splits the vocab over ``model``, else
    the whole vocab at this rank's positions (their gradient partial under
    ``seq``)."""

    if vocab_split(lay, spec, 1):
        return spmd.row(spmd.tp_enter(x, lay, seq), w, spec, lay)
    return ops.gemm(x, spmd.norm_weight(spmd.use(w, spec, lay), lay, seq))


def _attn_block_sharded(p, sp, x, cfg: ArchConfig, lay, positions, seq: bool, attn_backend):
    """An attention block and its GLU or MoE, a rank's part: ``(x, aux)``."""

    acfg = attn_config(cfg)
    h = L.apply_attention_tp(p["attn"], sp["attn"],
                             L.rms_norm(x, spmd.norm_weight(p["ln1"], lay, seq), cfg.norm_eps),
                             acfg, lay, positions=positions, seq=seq, backend=attn_backend)
    x = x + h
    xn = L.rms_norm(x, spmd.norm_weight(p["ln2"], lay, seq), cfg.norm_eps)
    if "moe" in p:
        h, aux = M.apply_moe_tp(p["moe"], sp["moe"], xn, cfg.moe, lay, seq=seq)
    else:
        h, aux = L.apply_glu_tp(p["mlp"], sp["mlp"], xn, lay, seq=seq), 0.0
    return x + h, aux


def one_card_only(cfg: ArchConfig) -> None:
    """Raise for a config whose tied head no sharded step holds."""

    if cfg.tie_embeddings:
        raise ValueError(f"{cfg.name} ties its output head to the embedding "
                         "(tie_embeddings); the sharded steps hold an lm_head leaf: one card only")


def forward_lm_sharded(params, cfg: ArchConfig, batch, lay, *, attn_backend: str = "auto",
                       remat: bool = False):
    """:func:`forward_lm` on a mesh: returns ``(logits, aux)``, the logits
    this rank's rows (B_local, S, V / model), their vocab split over
    ``model`` as the reference's ``constrain_batch(logits, extra=("model",))``
    pins them; ``aux`` this rank's term of the MoE router loss (the dp
    ranks' terms add up to the reference's; 0 for the other families).
    Each layer's FSDP gathers run inside its body, so ``remat`` gathers
    again in the backward.  The hybrid's shared block runs after each
    group of Mamba2 layers on the stream whole over ``model``."""

    one_card_only(cfg)
    b, s = (batch["embeds"] if cfg.embed_inputs else batch["tokens"]).shape[:2]
    kind = block_kind(cfg)
    seq = stream_seq(cfg, lay, b, s)
    x = embed_tokens_sharded(params, cfg, batch, lay, seq=seq)
    positions = torch.arange(s, device=x.device)[None, :]
    specs = spmd.layer_specs(lay.specs["blocks"])

    if kind == "mamba":
        def body(x, p):
            h = S.apply_mamba2_tp(p["mamba"], specs["mamba"], L.rms_norm(x, p["ln"], cfg.norm_eps),
                                  cfg.ssm, lay)
            return x + h, 0.0
    else:
        def body(x, p):
            return _attn_block_sharded(p, specs, x, cfg, lay, positions, seq, attn_backend)

    layers = _unstack(_cast_params(params["blocks"]), cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    every = cfg.shared_attn_every
    if every:
        shared, shared_specs = _cast_params(params["shared"]), lay.specs["shared"]
        shared_fn = lambda xx: _attn_block_sharded(shared, shared_specs, xx, cfg, lay,  # noqa: E731
                                                   positions, False, attn_backend)[0]
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
    x = L.rms_norm(x, spmd.norm_weight(params["final_norm"], lay, seq), cfg.norm_eps)
    logits = lm_head_sharded(x, params["lm_head"].to(L.COMPUTE_DTYPE), lay.specs["lm_head"], lay,
                             seq)
    return logits, aux


def cross_entropy_sharded(logits, labels, lay, mask=None, *, vocab_split: bool = True,
                          seq: bool = False):
    """The cross-entropy of this rank's rows: vocab-parallel (the row max,
    the sum of exponentials and the target's logit each reduced over
    ``model``), or over a whole vocab at this rank's positions (``seq``:
    split over ``model``, their sums reduced there); the sum over this
    rank's tokens divided by the *global* token count (the dp ranks'
    counts all-reduced), so that the dp ranks' terms add up to the
    reference's mean (``spmd.dp_sum``)."""

    lf = logits.float()
    if vocab_split:
        mx = C.all_reduce(lf.amax(dim=-1).detach(), lay.mesh, "model", op="max")
        shifted = lf - mx[..., None]
        lse = torch.log(C.reduce(torch.exp(shifted).sum(dim=-1), lay.mesh, "model"))
        v_loc = lf.shape[-1]
        local = labels.long() - lay.model_index * v_loc
        ok = (local >= 0) & (local < v_loc)
        tgt = shifted.gather(-1, torch.clamp(local, 0, v_loc - 1)[..., None])[..., 0]
        tgt = C.reduce(torch.where(ok, tgt, torch.zeros((), device=tgt.device)), lay.mesh, "model")
    else:
        shifted = lf - lf.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(shifted).sum(dim=-1))
        tgt = shifted.gather(-1, labels.long()[..., None])[..., 0]
    ll = tgt - lse
    if mask is None:
        num, count = ll.sum(), torch.tensor(float(ll.numel()), device=ll.device)
    else:
        mask = mask.float()
        num, count = (ll * mask).sum(), mask.sum()
    axes = tuple(lay.dp or ())
    if seq:
        num = C.reduce(num, lay.mesh, "model")
        axes += ("model",)
    count = C.all_reduce(count.detach(), lay.mesh, axes)
    return -num / torch.clamp(count, min=1.0)


def sharded_ce(logits, batch, lay, spec, seq: bool):
    """:func:`cross_entropy_sharded` of a forward's logits against the
    batch's labels (and mask), the head's ``spec`` saying how the vocab
    lies: whole at this rank's positions under ``seq``, else split."""

    split = vocab_split(lay, spec, 1)
    local = not split and seq
    labels, mask = batch["labels"], batch.get("mask")
    if local:
        labels = _seq_local(labels, lay, True)
        mask = _seq_local(mask, lay, True) if mask is not None else None
    return cross_entropy_sharded(logits, labels, lay, mask, vocab_split=split, seq=local)


def loss_fn_sharded(params, cfg: ArchConfig, batch, lay, *, attn_backend: str = "auto",
                    remat: bool = False):
    """``(loss, {"ce", "aux"})`` of this rank's rows: its term of the global
    mean (``spmd.dp_sum`` over the dp ranks gives the reference's loss)."""

    one_card_only(cfg)
    logits, aux = forward_lm_sharded(params, cfg, batch, lay, attn_backend=attn_backend,
                                     remat=remat)
    b, s = (batch["embeds"] if cfg.embed_inputs else batch["tokens"]).shape[:2]
    ce = sharded_ce(logits, batch, lay, lay.specs["lm_head"], stream_seq(cfg, lay, b, s))
    return ce + aux, {"ce": ce, "aux": aux}


def cache_plan(cache_k, spec, lay, acfg: L.AttnConfig, pos, b: int) -> dict:
    """How one KV cache of the step lies: its length's axes (``spec``, the
    cache's ``sharding.cache_pspec``; dim 2), its global length and the
    step's write plan (``layers.cache_split_plan``), one for every layer."""

    axes = SH._axes(spec[2])
    s_local = cache_k.shape[2]
    s_total = s_local * lay.mesh.size(axes)
    plan = L.cache_split_plan(pos, b, s_local, s_total, lay, axes, acfg.window, cache_k.device)
    return {"len_axes": axes, "s_total": s_total, "plan": plan}


def _decode_attn_block_sharded(p, sp, x, cfg: ArchConfig, acfg: L.AttnConfig, lay, k, v, kv,
                               pos, live):
    h = L.decode_attention_tp(p["attn"], sp["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), acfg,
                              lay, k, v, pos, plan=kv["plan"], s_total=kv["s_total"],
                              len_axes=kv["len_axes"], live=live)
    x = x + h
    xn = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x + M.apply_moe_tp(p["moe"], sp["moe"], xn, cfg.moe, lay, seq=False)[0]
    return x + L.apply_glu_tp(p["mlp"], sp["mlp"], xn, lay, seq=False)


def _decode_mamba_sharded(params, cfg: ArchConfig, x, state, pos, lay, cache_specs):
    """:func:`_decode_mamba` as a rank's part: the SSM states on their heads
    (``cache_specs``), the hybrid's shared block over its ring, split as
    its ``shared_k`` spec says."""

    every = cfg.shared_attn_every
    n_run = n_groups(cfg) * every if every else cfg.n_layers
    specs = spmd.layer_specs(lay.specs["blocks"])
    head_axes = SH._axes(cache_specs["mamba"]["ssm"][2])
    if every:
        axes = SH._axes(cache_specs["shared_k"][2])
        sc = state["shared_k"].shape[2] * lay.mesh.size(axes)
        shared_cfg = dataclasses.replace(attn_config(cfg), window=sc if sc < 524288 else None)
        kv = cache_plan(state["shared_k"], cache_specs["shared_k"], lay, shared_cfg, pos,
                        x.shape[0])
    for i in range(n_run):
        p = layer_params(params["blocks"], i)
        h, _ = S.decode_mamba2_tp(p["mamba"], specs["mamba"], L.rms_norm(x, p["ln"], cfg.norm_eps),
                                  cfg.ssm, lay, layer_params(state["mamba"], i), head_axes)
        x = x + h
        if every and (i + 1) % every == 0:
            g = i // every
            x = _decode_attn_block_sharded(params["shared"], lay.specs["shared"], x, cfg,
                                           shared_cfg, lay, state["shared_k"][g],
                                           state["shared_v"][g], kv, pos, None)
    return x


def decode_step_sharded(params, cfg: ArchConfig, batch, state, pos, lay, cache_specs):
    """:func:`decode_step` on a mesh: this rank's rows (every row when the
    dp axes do not divide the batch: ``lay.rows_split`` false), its part of
    each cache (``cache_specs``, the state's ``sharding.cache_pspec`` tree:
    a KV cache's length split over ``model``, or over the dp axes and
    ``model`` for a batch of 1; an SSM state's heads likewise), the
    logits' vocab over ``model``; dense caches only (the reference never
    runs the paged engine on a data/model mesh)."""

    if "pages_k" in state:
        raise ValueError("the paged arena is not sharded over a data/model mesh")
    one_card_only(cfg)
    x = embed_tokens_sharded(params, cfg, batch, lay, seq=False)
    b = x.shape[0]
    if block_kind(cfg) == "mamba":
        x = _decode_mamba_sharded(params, cfg, x, state, pos, lay, cache_specs)
    else:
        acfg = attn_config(cfg)
        kv = cache_plan(state["k"], cache_specs["k"], lay, acfg, pos, b)
        specs = spmd.layer_specs(lay.specs["blocks"])
        live = batch.get("live")
        for i in range(cfg.n_layers):
            x = _decode_attn_block_sharded(layer_params(params["blocks"], i), specs, x, cfg, acfg,
                                           lay, state["k"][i], state["v"][i], kv, pos, live)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head_sharded(x, params["lm_head"].to(L.COMPUTE_DTYPE), lay.specs["lm_head"], lay,
                             False)
    return logits, state


__all__ = [
    "attn_config",
    "block_kind",
    "cache_len",
    "cache_plan",
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
    "hidden_lm",
    "init_decode_state",
    "init_decode_state_paged",
    "init_lm",
    "layer_params",
    "lm_head_sharded",
    "loss_fn",
    "n_groups",
    "one_card_only",
    "prefill",
    "sharded_ce",
    "stream_seq",
    "tied_head",
    "vocab_split",
]
