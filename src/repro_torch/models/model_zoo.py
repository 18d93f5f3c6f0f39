"""Family dispatch (the port's ``repro.models.model_zoo``): one API over
the reference's ten architectures.  The dense, MoE, SSM and hybrid
families (token or embedding inputs) run through
:mod:`repro_torch.models.transformer`, the encoder-decoder family through
:mod:`repro_torch.models.encdec`.

  * ``init_params(cfg, generator, device)``
  * ``make_loss_fn(cfg)``        -> (params, batch) -> (loss, metrics): the
    training loss for params that require grad, else the eval loss
  * ``make_prefill_fn(cfg)``     -> (params, batch) -> logits
    (``with_cache=True``: the bulk prefill from decode,
    (params, batch, state, pos0) -> (last_logits, state))
  * ``make_decode_fn(cfg)``      -> (params, batch, state, pos) -> (logits, state)
  * ``bulk_prefill_from_decode(decode_fn)`` -> the prompt-consuming prefill
  * ``init_decode_state(cfg, batch, seq_len, device=...)`` and its paged twin
  * ``batch_spec(cfg, shape)`` / ``decode_state_spec(cfg, batch, seq_len)``:
    a cell's inputs on the ``meta`` device (the dry-run's)

``make_prefill_fn``'s ``attn_backend`` names the forward's attention route
(``"auto"``: the CUDA kernel for tensors on a card, ``chunked_attention``
for tensors on the CPU).

Under a :class:`~repro_torch.launch.mesh.RankMesh` (``mesh=``) the same
entry points run a rank's part of every family's step
(``transformer.*_sharded``, ``encdec.*_sharded``): the params are its
shards by the reference's rules (``distributed/sharding.py``;
:func:`param_specs`), the batch its rows over the dp axes (all of them
when the dp axes do not divide it), the decode state its part by
``sharding.cache_pspec`` (:func:`decode_state_specs`: a KV cache's rows
and its slice of the length, over the dp axes too for a batch of 1; an
SSM state's heads), the logits its rows and its vocab slice (the whole
vocab where ``model`` does not divide it; :func:`gather_logits` joins
them).  ``batch_spec``, ``decode_state_spec`` and ``init_decode_state``
give the rank-local shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.observability import trace
from repro_torch.optim import adamw as O


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda", *,
                dtype: torch.dtype = torch.bfloat16):
    """Random params; ``dtype`` stores the projections, ``embed`` and
    ``lm_head`` (bf16 to serve, fp32 masters to train)."""

    if cfg.family == "encdec":
        return E.init_encdec(generator, cfg, device=device, dtype=dtype)
    return T.init_lm(generator, cfg, device=device, dtype=dtype)


def bulk_prefill_from_decode(decode_fn):
    """Build the prefill from any decode-step-compatible fn.

    ``decode_fn(params, {"tokens": (B,1), ...}, state, pos)`` becomes
    ``(params, {"tokens": (B,P), ...}, state, pos0, plens=None) -> (logits,
    state)``: a loop over prompt positions in place of the reference's
    ``lax.scan``.  The loop body *is* the decode recurrence, so the cache
    it writes is bitwise equal to the token-by-token replay.  Every batch
    key besides ``"tokens"`` is passed to each step unchanged.

    ``plens`` ((B,) int32, optional) supports mixed-length prompts in one
    call: prompts are right-padded, every row runs every padded step, and
    each row's returned logits are those of its own last real token
    ``t == plens[row] - 1``.  A row past its prompt (``t >= plens[row]``)
    keeps its recurrent state (the Mamba2 leaves, ``state["mamba"]``)
    through the pad step: the step's writes to those rows are undone, so a
    short prompt's state is the one it has served alone.  KV caches are
    left as the step wrote them: a pad write lands past the row's
    position, which its attention masks and its later decode overwrites.
    """

    def f(params, batch, state, pos0, plens=None):
        if "tokens" not in batch:
            raise ValueError("bulk prefill needs a token-in batch ({'tokens': (B,P)})")
        tokens = batch["tokens"]
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        plen = tokens.shape[1]
        lens = None
        if plens is not None:
            last = torch.as_tensor(plens, dtype=torch.int32, device=tokens.device) - 1
            if _recurrent_leaves(state):
                lens = torch.as_tensor(plens).tolist()
        logits = None
        for t in range(plen):
            done = [r for r, n in enumerate(lens) if t >= n] if lens is not None else []
            if done:
                rows = torch.tensor(done, dtype=torch.long, device=tokens.device)
                kept = [leaf.index_select(1, rows) for leaf in _recurrent_leaves(state)]
            lg, state = decode_fn(params, dict(extras, tokens=tokens[:, t:t + 1]), state, pos0 + t)
            if done:
                for leaf, old in zip(_recurrent_leaves(state), kept):
                    leaf.index_copy_(1, rows, old)
            if logits is None or plens is None:
                logits = lg
            else:
                logits = torch.where((last == t)[:, None, None], lg, logits)
        return logits, state

    return f


def _recurrent_leaves(state) -> list:
    """The leaves of a decode state that carry a recurrence (the Mamba2
    state, slot dim 1), in a fixed order; empty for KV-only states."""

    rec = state.get("mamba") if isinstance(state, dict) else None
    return [rec[k] for k in sorted(rec)] if rec else []


def param_specs(cfg: ArchConfig, mesh, *, fsdp: bool) -> dict:
    """The spec tree of ``cfg``'s params on ``mesh`` (the reference's
    ``shard_params``; ``fsdp=False`` for serving params)."""

    return spmd.param_specs(init_params(cfg, None, "meta", dtype=torch.float32), mesh, fsdp=fsdp)


def _layout(cfg, mesh, *, fsdp: bool, seq_shard: bool = False) -> spmd.Layout:
    return spmd.Layout(mesh, param_specs(cfg, mesh, fsdp=fsdp), seq_shard)


def _global_state(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The whole decode state on ``meta`` (shapes and dtypes)."""

    init = E.init_decode_state if cfg.family == "encdec" else T.init_decode_state
    return init(cfg, batch, seq_len, device="meta")


def decode_state_specs(cfg: ArchConfig, mesh, batch: int, seq_len: int) -> dict:
    """The spec tree of the decode state of ``batch`` rows and ``seq_len``
    positions on ``mesh`` (the reference's ``cache_pspec`` of each leaf)."""

    return O.tree_map(lambda t: SH.cache_pspec(mesh, tuple(t.shape)),
                      _global_state(cfg, batch, seq_len))


def gather_logits(logits, cfg: ArchConfig, mesh, batch: int):
    """A sharded step's logits of ``batch`` rows, whole on every rank: the
    vocab joined over ``model`` where the head splits it, the rows over
    the dp axes where the batch splits there (no autograd)."""

    from repro_torch.distributed import collectives as C

    T.one_card_only(cfg)
    specs = param_specs(cfg, mesh, fsdp=False)
    head = SH.P(*reversed(specs["embed"])) if cfg.family == "encdec" else specs["lm_head"]
    if spmd.splits_model(head, 1):
        logits = C.all_gather(logits, mesh, "model", logits.ndim - 1)
    rows = SH.batch_pspec(mesh, batch)
    return C.all_gather(logits, mesh, rows[0], 0) if rows[0] is not None else logits


def _decode_layout(cfg, mesh, batch: int) -> spmd.Layout:
    lay = _layout(cfg, mesh, fsdp=False)
    return dataclasses.replace(lay, rows_split=SH.batch_pspec(mesh, batch)[0] is not None)


def make_decode_fn(cfg: ArchConfig, *, mesh=None, batch: int = 0, seq_len: int = 0):
    """``(params, batch, state, pos) -> (logits, state)``; on a rank mesh a
    rank's part of the step over the caches of ``batch`` rows and
    ``seq_len`` positions (their global shape, which their spec reads)."""

    if spmd.is_sharded(mesh):
        lay = _decode_layout(cfg, mesh, batch)
        cspecs = decode_state_specs(cfg, mesh, batch, seq_len)
        sharded = E.decode_step_sharded if cfg.family == "encdec" else T.decode_step_sharded

        def f(params, batch_, state, pos):
            return sharded(params, cfg, batch_, state, pos, lay, cspecs)

        f.layout, f.cache_specs = lay, cspecs
        return f
    step = E.decode_step if cfg.family == "encdec" else T.decode_step

    def f(params, batch, state, pos):
        return step(params, cfg, batch, state, pos)

    return f


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def make_loss_fn(cfg: ArchConfig, *, remat: bool = True, mesh=None, fsdp: bool = True,
                 seq_shard: bool = False):
    """``(params, batch) -> (loss, {"ce", "aux"})``.

    When autograd will differentiate it (grad mode on and a leaf of
    ``params`` requires grad: the trainer's fp32 masters) it is the
    training loss, with ``remat`` each layer body recomputed in the
    backward.  Otherwise (serving params, ``no_grad``, ``inference_mode``)
    it is the eval loss.  Both take their attention by ``"auto"``: on a
    card the flash kernels (in training the log-sum-exp forward and the
    backward kernels, ``kernels/flash_attention.FlashAttentionFn``), on
    the CPU ``chunked_attention``, the reference's training arithmetic.
    The enc-dec's cross-attention takes the route of its self-attention.
    On a rank mesh the loss is this rank's term of the global mean (the dp
    ranks' terms add up to it) over params sharded by ``fsdp``, its stream
    sequence-sharded under ``seq_shard``.
    """

    if spmd.is_sharded(mesh):
        lay = _layout(cfg, mesh, fsdp=fsdp, seq_shard=seq_shard)
        sharded = E.loss_fn_sharded if cfg.family == "encdec" else T.loss_fn_sharded

        def f(params, batch):
            if torch.is_grad_enabled() and _requires_grad(params):
                return sharded(params, cfg, batch, lay, attn_backend="auto", remat=remat)
            return sharded(params, cfg, batch, lay)

        f.layout = lay
        return f
    loss = E.loss_fn if cfg.family == "encdec" else T.loss_fn

    def f(params, batch):
        if torch.is_grad_enabled() and _requires_grad(params):
            return loss(params, cfg, batch, attn_backend="auto", remat=remat)
        return loss(params, cfg, batch)

    return f


def make_prefill_fn(cfg: ArchConfig, *, with_cache: bool = False, attn_backend: str = "auto",
                    mesh=None, seq_shard: bool = False, batch: int = 0, seq_len: int = 0):
    """Prefill forward.

    ``with_cache=False`` (default): the full-sequence forward,
    ``(params, batch) -> logits`` — logits-only prefill (scoring).

    ``with_cache=True``: the bulk prefill the serving stack uses,
    ``(params, batch, state, pos0) -> (last_logits, state)``, a loop of
    :func:`make_decode_fn` steps (see :func:`bulk_prefill_from_decode`).

    On a rank mesh a rank's part over serving params (no FSDP): its rows'
    logits, their vocab over ``model`` (``with_cache``: the caches of
    ``batch`` rows and ``seq_len`` positions).  The logits-only forward
    is the ``model.prefill`` span.
    """

    if with_cache:
        return bulk_prefill_from_decode(make_decode_fn(cfg, mesh=mesh, batch=batch,
                                                       seq_len=seq_len))
    if spmd.is_sharded(mesh):
        lay = _layout(cfg, mesh, fsdp=False, seq_shard=seq_shard)
        fwd = E.forward_encdec_sharded if cfg.family == "encdec" else T.forward_lm_sharded

        def f(params, batch_):
            with _prefill_span(batch_), torch.inference_mode():
                return fwd(params, cfg, batch_, lay, attn_backend=attn_backend)[0]

        return f

    def f(params, batch):
        with _prefill_span(batch), torch.inference_mode():
            if cfg.family == "encdec":
                return E.forward_encdec(params, cfg, batch, attn_backend=attn_backend)[0]
            return T.prefill(params, cfg, batch, attn_backend=attn_backend)

    return f


def _prefill_span(batch):
    """The ``model.prefill`` span of a forward over ``batch``: its rows and
    length (of the tokens, else the embeddings)."""

    rows, length = batch["tokens" if "tokens" in batch else "embeds"].shape[:2]
    return trace.span("model.prefill", cat="model", rows=rows, length=length)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *, device="cuda", mesh=None):
    """The decode state of ``batch`` rows and ``seq_len`` positions; on a
    rank mesh this rank's part of it (``sharding.cache_pspec``)."""

    if spmd.is_sharded(mesh):
        return spmd.map_specs(
            lambda t, spec: torch.zeros(SH.local_shape(tuple(t.shape), spec, mesh), dtype=t.dtype,
                                        device=device),
            _global_state(cfg, batch, seq_len), decode_state_specs(cfg, mesh, batch, seq_len))
    if cfg.family == "encdec":
        return E.init_decode_state(cfg, batch, seq_len, device=device)
    return T.init_decode_state(cfg, batch, seq_len, device=device)


def init_decode_state_paged(cfg: ArchConfig, n_pages: int, page_size: int, *, device="cuda"):
    """Paged decode cache (pure KV-cache families only; see transformer)."""

    if cfg.family == "encdec":
        raise ValueError("paged KV state does not cover the encdec cross-KV cache")
    return T.init_decode_state_paged(cfg, n_pages, page_size, device=device)


def batch_spec(cfg: ArchConfig, shape, *, device="meta", mesh=None) -> dict:
    """Inputs for one (arch x shape) cell, as the reference's ``batch_spec``
    gives them: tokens (int32), embeddings (the compute dtype), labels for
    a train cell, one position for a decode cell.  On the ``meta`` device
    (the default) they hold shapes and dtypes only, as the reference's
    ``ShapeDtypeStruct`` s do; elsewhere they are zeros.  On a rank mesh,
    this rank's rows (``sharding.batch_pspec``)."""

    from repro_torch.models.layers import COMPUTE_DTYPE

    b, s = shape.global_batch, shape.seq_len
    if spmd.is_sharded(mesh):
        b = SH.local_shape((b,), SH.batch_pspec(mesh, b), mesh)[0]
    tok = lambda ss: torch.zeros((b, ss), dtype=torch.int32, device=device)  # noqa: E731
    emb = lambda ss: torch.zeros((b, ss, cfg.d_model), dtype=COMPUTE_DTYPE, device=device)  # noqa: E731

    if shape.kind == "decode":
        return {"embeds": emb(1)} if cfg.embed_inputs else {"tokens": tok(1)}
    if cfg.family == "encdec":
        out = {"frames": emb(s), "tokens": tok(s)}
    elif cfg.embed_inputs:
        out = {"embeds": emb(s)}
    else:
        out = {"tokens": tok(s)}
    if shape.kind == "train":
        out["labels"] = tok(s)
    return out


def decode_state_spec(cfg: ArchConfig, batch: int, seq_len: int, *, device="meta", mesh=None):
    """The decode state of ``batch`` rows and ``seq_len`` positions; on the
    ``meta`` device (the default) shapes and dtypes only, no memory; on a
    rank mesh this rank's part."""

    return init_decode_state(cfg, batch, seq_len, device=device, mesh=mesh)


__all__ = [
    "batch_spec",
    "bulk_prefill_from_decode",
    "decode_state_spec",
    "decode_state_specs",
    "gather_logits",
    "init_decode_state",
    "init_decode_state_paged",
    "init_params",
    "make_decode_fn",
    "make_loss_fn",
    "make_prefill_fn",
    "param_specs",
]
