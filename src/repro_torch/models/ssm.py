"""Mamba2 (state-space duality) blocks: the full-sequence chunked scan and
the recurrent decode step (the port's ``repro.models.ssm``).

The SSD chunked algorithm [arXiv:2405.21060] splits the sequence into
chunks of ``cfg.chunk`` steps: within a chunk the output is a dense masked
product (a (Q, Q) decay-weighted ``C · B`` matrix times ``x``), across
chunks a recurrent state ``(B, H, d_state, headdim)`` carries the rest.
Everything past the projections runs in fp32, as in the reference.

Decode is the dual recurrent form: one step updates the constant-size
state and the two causal-conv histories; the port writes them **in place**
(the reference threads them through donated jit arguments).

As in the reference, z/x/B·C/dt are four separate projections and every
projection (and ``out_proj``) is a plain bf16 product (``torch.matmul``):
the reference computes them with ``jnp.einsum``, outside its GEMM kernel.

Every full-sequence scan is counted in :data:`SCANS` and, while a span
records, traced: ``ssm.scan`` (tagged ``forward`` or ``recompute``) and
``ssm.scan.backward`` (:func:`_scan`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import SSMConfig
from repro_torch.kernels import ssd as SSD
from repro_torch.models import layers as L
from repro_torch.observability import trace

# The leaves that enter the scan in fp32 under ``ArchConfig.residual_in_fp32``
# (``transformer._cast_params`` leaves them uncast).
FP32_LEAVES = frozenset({"A_log", "dt_bias", "D"})

# Scan calls and their chunks since the last reset: the card's cross-check
# of a step's frozen counts, as ``kernels.gemm.LAUNCHES`` is the funnel's.
SCANS: dict[str, int] = {"calls": 0, "chunks": 0}


def reset_scans() -> None:
    SCANS.update(calls=0, chunks=0)


def init_mamba2(generator, cfg: SSMConfig, n_layers: int, *, device,
                dtype: torch.dtype = L.COMPUTE_DTYPE) -> dict:
    """``n_layers`` stacked Mamba2 blocks at the reference's scales.  The
    projections are stored in ``dtype``; the conv weights and biases,
    ``dt_bias``, ``A_log``, ``D`` and ``norm_w`` stay fp32 (the decode step
    uses them in fp32).

    With ``cfg.published_init``, mamba_ssm's initialisation: ``A_log =
    log U(A_init_range)``; ``dt_bias`` the inverse softplus of ``dt =
    exp(U(log dt_min, log dt_max))`` floored at ``dt_init_floor``; the
    convolutions PyTorch's ``Conv1d`` default, ``U(±1/sqrt(d_conv))``; the
    four in-projections at one scale, as the column blocks of one
    ``in_proj``; ``out_proj`` divided by ``sqrt(n_layers)``
    (``rescale_prenorm_residual``)."""

    nl, d, di, nh, k = n_layers, cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_conv
    gn2 = 2 * cfg.n_groups * cfg.d_state
    pub = cfg.published_init
    dense = lambda shape, scale=None, dt=dtype: L.dense_init(  # noqa: E731
        generator, (nl,) + shape, scale, device=device, dtype=dt)
    full = lambda shape, value: torch.full((nl,) + shape, value, dtype=L.PARAM_DTYPE,  # noqa: E731
                                           device=device)
    uni = lambda shape, lo, hi: L.uniform_init(generator, (nl,) + shape, lo, hi,  # noqa: E731
                                               device=device)
    tap = 1.0 / math.sqrt(k)
    conv_w = lambda c: uni((k, c), -tap, tap) if pub else dense((k, c), 0.5, L.PARAM_DTYPE)  # noqa: E731
    conv_b = lambda c: uni((c,), -tap, tap) if pub else full((c,), 0.0)  # noqa: E731
    return {
        "wz": dense((d, di)),
        "wx": dense((d, di)),
        "wbc": dense((d, gn2)),
        "wdt": dense((d, nh), None if pub else 0.02),
        "conv_w_x": conv_w(di),
        "conv_b_x": conv_b(di),
        "conv_w_bc": conv_w(gn2),
        "conv_b_bc": conv_b(gn2),
        "dt_bias": _dt_bias(uni((nh,), math.log(cfg.dt_min), math.log(cfg.dt_max)), cfg)
        if pub else full((nh,), 0.0),
        "A_log": torch.log(uni((nh,), *cfg.A_init_range)) if pub else full((nh,), 0.0),
        "D": full((nh,), 1.0),
        "norm_w": full((di,), 1.0),
        "out_proj": dense((di, d), 1.0 / math.sqrt(di * nl) if pub else None),
    }


def _dt_bias(log_dt, cfg: SSMConfig):
    """The bias whose softplus is ``dt = exp(log_dt)`` floored at
    ``cfg.dt_init_floor``: ``dt + log(-expm1(-dt))``."""

    dt = torch.clamp(torch.exp(log_dt), min=cfg.dt_init_floor)
    return dt + torch.log(-torch.expm1(-dt))


def _causal_conv(u, w, b, d_conv: int, conv_state=None):
    """Depthwise causal conv + SiLU in fp32. u: (B, S, C); w: (K, C).

    With ``conv_state`` ((B, K-1, C), the decode form) ``u`` is one step;
    returns ``(out, the new history)``.  The full-sequence form returns
    ``(out, None)``."""

    wf, bf = w.float(), b.float()
    if conv_state is not None:
        window = torch.cat([conv_state, u], dim=1)  # (B, K, C)
        out = torch.einsum("bkc,kc->bc", window.float(), wf)
        out = F.silu(out + bf)
        return out[:, None].to(u.dtype), window[:, 1:]
    s = u.shape[1]
    pad = F.pad(u, (0, 0, d_conv - 1, 0))
    stacked = torch.stack([pad[:, i:i + s] for i in range(d_conv)], dim=2)  # (B, S, K, C)
    out = torch.einsum("bskc,kc->bsc", stacked.float(), wf)
    return F.silu(out + bf).to(u.dtype), None


def _ssd_chunked(x, dt, A, Bm, Cm, cfg: SSMConfig, init_state=None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative
    rates; Bm, Cm: (B, S, G, N).  Returns ``(y in x's dtype, final state
    (B, H, N, P) fp32)``.
    """

    if x.is_cuda:
        L.CUDA_CALLS["ssd_chunked"] += 1
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(cfg.chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    rep = h // g
    dev = x.device

    xq = x.reshape(b, nc, q, h, p).float()
    dtq = dt.reshape(b, nc, q, h)
    bq = Bm.reshape(b, nc, q, g, n).float()
    cq = Cm.reshape(b, nc, q, g, n).float()

    # log decay per step: dA = A * dt (A < 0), its running sum l_t per chunk.
    da = (A[None, None, None, :] * dtq).float()                   # (B, nc, Q, H)
    cum = torch.cumsum(da, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (B, nc, Q, Q, H)
    # Masked before the exponential: above the diagonal seg > 0 and exp
    # overflows, and inf times the masked zero would be NaN.
    causal = torch.ones((q, q), dtype=torch.bool, device=dev).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, seg, torch.full((), -torch.inf, device=dev)))
    del seg

    # intra-chunk: scores[t, s] = (C_t · B_s) * exp(l_t - l_s) * dt_s
    cb = torch.einsum("bcqgn,bcsgn->bcqsg", cq, bq)
    cb_h = cb[..., None].expand(b, nc, q, q, g, rep).reshape(b, nc, q, q, h)
    scores = cb_h * decay * dtq[:, :, None, :, :]
    del cb, cb_h, decay
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xq)
    del scores

    # per-chunk state contribution: sum_s exp(l_Q - l_s) dt_s B_s ⊗ x_s
    tail = torch.exp(cum[:, :, -1:, :] - cum)                      # (B, nc, Q, H)
    w = tail * dtq
    bqh = bq[:, :, :, :, None, :].expand(b, nc, q, g, rep, n).reshape(b, nc, q, h, n)
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp", bqh * w[..., None], xq)
    chunk_decay = torch.exp(cum[:, :, -1, :])                      # (B, nc, H)
    cqh = cq[:, :, :, :, None, :].expand(b, nc, q, g, rep, n).reshape(b, nc, q, h, n)

    # across chunks: the reference's lax.scan, as a loop over chunks.
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, n, p), dtype=torch.float32, device=dev))
    y_inter = []
    for c in range(nc):
        c_h = cqh[:, c] * torch.exp(cum[:, c])[..., None]           # (B, Q, H, N)
        y_inter.append(torch.einsum("bqhn,bhnp->bqhp", c_h, state))
        state = chunk_decay[:, c][..., None, None] * state + chunk_state[:, c]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(b, s, h, p)
    return y.to(x.dtype), state


class _OpenBackward(torch.autograd.Function):
    """Identity on the scan's output; its backward, the scan's backward's
    first node, opens the ``ssm.scan.backward`` span into ``box``."""

    @staticmethod
    def forward(ctx, box, tags, y):
        ctx.box, ctx.tags = box, tags
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        sp = trace.span("ssm.scan.backward", cat="model", **ctx.tags)
        ctx.box.append(sp.__enter__())
        return None, None, g


class _CloseBackward(torch.autograd.Function):
    """Identity on the scan's inputs; its backward, which runs once every
    input's gradient is in, closes the span ``box`` holds."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        while ctx.box:
            ctx.box.pop().__exit__(None, None, None)
        return (None,) + grads


def _ssd(x, dt, A, Bm, Cm, cfg: SSMConfig, init_state=None):
    """The scan through ``kernels/ssd.ssd_scan_cuda`` where its kernels
    take the inputs (``kernel_takes``: bf16 x, B, C on a card at their
    shapes), else :func:`_ssd_chunked`."""

    if SSD.kernel_takes(x, dt, A, Bm, Cm, cfg.chunk, init_state):
        return SSD.ssd_scan_cuda(x, dt, A, Bm, Cm, cfg.chunk, init_state=init_state)
    return _ssd_chunked(x, dt, A, Bm, Cm, cfg, init_state=init_state)


def _scan(x, dt, A, Bm, Cm, cfg: SSMConfig, init_state=None):
    """:func:`_ssd`, counted in :data:`SCANS`.  While a span
    records (``trace.live``) it runs under the ``ssm.scan`` span, tagged
    with its shapes and its ``phase`` (``recompute`` inside a remat
    backward, else ``forward``), and, where autograd records it, its
    backward between two identity nodes that bracket the
    ``ssm.scan.backward`` span."""

    b, s, h, p = x.shape
    q = min(cfg.chunk, s)
    SCANS["calls"] += 1
    SCANS["chunks"] += s // q
    if not trace.live():
        return _ssd(x, dt, A, Bm, Cm, cfg, init_state=init_state)
    tags = dict(rows=b, seq=s, heads=h, headdim=p, d_state=Bm.shape[3], groups=Bm.shape[2],
                chunk=q)
    ins = (x, dt, A, Bm, Cm)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    box = []
    if grad:
        x, dt, A, Bm, Cm = _CloseBackward.apply(box, *ins)
    phase = "recompute" if L.RECOMPUTING.get() else "forward"
    with trace.span("ssm.scan", cat="model", phase=phase, **tags):
        y, state = _ssd(x, dt, A, Bm, Cm, cfg, init_state=init_state)
    if grad:
        y = _OpenBackward.apply(box, tags, y)
    return y, state


def _project(p, xin, cfg: SSMConfig):
    xc = xin.to(L.COMPUTE_DTYPE)
    c = lambda name: p[name].to(L.COMPUTE_DTYPE)  # noqa: E731
    return (torch.matmul(xc, c("wz")), torch.matmul(xc, c("wx")),
            torch.matmul(xc, c("wbc")), torch.matmul(xc, c("wdt")))


def _finalize(p, y, z, xin, cfg: SSMConfig):
    b, s = xin.shape[0], xin.shape[1]
    y = y.reshape(b, s, cfg.d_inner).to(L.COMPUTE_DTYPE)
    y = y * F.silu(z.float()).to(L.COMPUTE_DTYPE)
    y = L.rms_norm(y, p["norm_w"])
    out = torch.matmul(y, p["out_proj"].to(L.COMPUTE_DTYPE))
    return out.to(xin.dtype)


def _rates(p, dt):
    """(post-softplus dt, A) in fp32."""

    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    return dtv, -torch.exp(p["A_log"].float())


def apply_mamba2(p, xin, cfg: SSMConfig, *, init_state=None):
    """Full-sequence Mamba2 block. xin: (B, S, D) -> (y, final SSM state)."""

    z, xu, bc, dt = _project(p, xin, cfg)
    xu, _ = _causal_conv(xu, p["conv_w_x"], p["conv_b_x"], cfg.d_conv)
    bc, _ = _causal_conv(bc, p["conv_w_bc"], p["conv_b_bc"], cfg.d_conv)
    b, s, _ = xu.shape
    gn = cfg.n_groups * cfg.d_state
    x = xu.reshape(b, s, cfg.n_heads, cfg.headdim)
    Bm = bc[..., :gn].reshape(b, s, cfg.n_groups, cfg.d_state)
    Cm = bc[..., gn:].reshape(b, s, cfg.n_groups, cfg.d_state)
    dtv, A = _rates(p, dt)

    y, final = _scan(x, dtv, A, Bm, Cm, cfg, init_state=init_state)
    y = y + p["D"].float()[None, None, :, None] * x.float()
    return _finalize(p, y, z, xin, cfg), final


def init_mamba2_state(batch: int, cfg: SSMConfig, *, device, dtype=torch.float32) -> dict:
    gn2 = 2 * cfg.n_groups * cfg.d_state
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.headdim), dtype=dtype, device=device),
        "conv_x": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=L.COMPUTE_DTYPE, device=device),
        "conv_bc": torch.zeros((batch, cfg.d_conv - 1, gn2), dtype=L.COMPUTE_DTYPE, device=device),
    }


def decode_mamba2(p, xin, cfg: SSMConfig, state):
    """Single-token recurrent step. xin: (B, 1, D); ``state`` (one layer's
    ``init_mamba2_state`` leaves, or views of them) is written in place.
    Returns ``(out, state)``."""

    z, xu, bc, dt = _project(p, xin, cfg)
    xu, conv_x = _causal_conv(xu, p["conv_w_x"], p["conv_b_x"], cfg.d_conv,
                              conv_state=state["conv_x"])
    bc, conv_bc = _causal_conv(bc, p["conv_w_bc"], p["conv_b_bc"], cfg.d_conv,
                               conv_state=state["conv_bc"])
    b = xin.shape[0]
    gn = cfg.n_groups * cfg.d_state
    x = xu[:, 0].reshape(b, cfg.n_heads, cfg.headdim)
    Bm = bc[:, 0, :gn].reshape(b, cfg.n_groups, cfg.d_state)
    Cm = bc[:, 0, gn:].reshape(b, cfg.n_groups, cfg.d_state)
    dtv, A = _rates(p, dt[:, 0])

    rep = cfg.n_heads // cfg.n_groups
    Bh = torch.repeat_interleave(Bm, rep, dim=1).float()           # (B, H, N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).float()
    decay = torch.exp(A[None] * dtv)                               # (B, H)
    h = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh * dtv[..., None], x.float())
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    y = y + p["D"].float()[None, :, None] * x.float()
    out = _finalize(p, y[:, None], z, xin, cfg)
    state["ssm"].copy_(h)
    state["conv_x"].copy_(conv_x)
    state["conv_bc"].copy_(conv_bc)
    return out, state


# ---------------------------------------------------------------------------
# A rank's part on a (data, model) mesh
# ---------------------------------------------------------------------------
#
# The reference's rules: ``wz`` / ``wx`` / ``wdt`` column-parallel (the
# heads split over ``model``), ``wbc`` and ``conv_w_bc`` / ``conv_b_bc``
# whole (B and C computed alike on every model rank), ``conv_w_x`` and the
# ``_VEC_MODEL`` leaves (``conv_b_x``, ``dt_bias``, ``A_log``, ``D``,
# ``norm_w``) on the rank's channels or heads, ``out_proj`` row-parallel.
# The stream is whole over ``model`` (the reference never
# sequence-shards a Mamba layer: ``constrain_batch(x, allow_seq=False)``).


def _check_groups(cfg: SSMConfig, lay) -> None:
    if lay.model > 1 and cfg.n_groups != 1:
        raise ValueError(f"the sharded Mamba2 block reads one B/C group, not {cfg.n_groups}")


def _finalize_tp(p, sp, y, z, xin, lay):
    """:func:`_finalize` on this rank's channels: the gated RMSNorm's mean
    over the whole ``d_inner`` (``spmd.rms_norm_split``), ``out_proj``
    row-parallel, its partial sums reduced in fp32 and rounded once, as
    one card rounds the whole sum (bf16 partials rounded on each rank move
    the reduced model's gradients by 3-4% through the Mamba2 layers)."""

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import spmd

    b, s = xin.shape[0], xin.shape[1]
    y = y.reshape(b, s, z.shape[-1]).to(L.COMPUTE_DTYPE)
    y = y * F.silu(z.float()).to(L.COMPUTE_DTYPE)
    y = spmd.rms_norm_split(y, p["norm_w"], lay)
    w = spmd.use(p["out_proj"].to(L.COMPUTE_DTYPE), sp["out_proj"], lay)
    out = torch.matmul(y.float(), w.float())
    return C.reduce(out, lay.mesh, "model").to(xin.dtype)


def apply_mamba2_tp(p, sp, xin, cfg: SSMConfig, lay):
    """:func:`apply_mamba2` as a rank's part: ``xin`` (B, S, D) this rank's
    rows, whole over ``model``; the scan runs on this rank's heads.
    Returns the block's output (B, S, D), whole over ``model``."""

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import spmd

    _check_groups(cfg, lay)
    mesh = lay.mesh
    xe = C.enter(xin, mesh, "model")
    z = spmd.plain(xe, p["wz"], sp["wz"], lay)
    xu = spmd.plain(xe, p["wx"], sp["wx"], lay)
    dt = spmd.plain(xe, p["wdt"], sp["wdt"], lay)
    bc = spmd.plain(xin, p["wbc"], sp["wbc"], lay)
    xu, _ = _causal_conv(xu, p["conv_w_x"], p["conv_b_x"], cfg.d_conv)
    bc, _ = _causal_conv(bc, p["conv_w_bc"], p["conv_b_bc"], cfg.d_conv)
    b, s, di = xu.shape
    gn = cfg.n_groups * cfg.d_state
    x = xu.reshape(b, s, di // cfg.headdim, cfg.headdim)
    # Each rank's heads read all of B and C: their gradients are partial,
    # summed over model in fp32 (the scan reads them in fp32).
    bc = C.enter(bc.float(), mesh, "model")
    Bm = bc[..., :gn].reshape(b, s, cfg.n_groups, cfg.d_state)
    Cm = bc[..., gn:].reshape(b, s, cfg.n_groups, cfg.d_state)
    dtv, A = _rates(p, dt)
    y, _ = _scan(x, dtv, A, Bm, Cm, cfg)
    y = y + p["D"].float()[None, None, :, None] * x.float()
    return _finalize_tp(p, sp, y, z, xin, lay)


def decode_mamba2_tp(p, sp, xin, cfg: SSMConfig, lay, state, head_axes=("model",)):
    """:func:`decode_mamba2` as a rank's part; ``state`` holds this rank's
    leaves, written in place: ``ssm`` (B, H_s, N, P) its heads over
    ``head_axes`` (``sharding.cache_pspec``: ``model``, with a batch of 1
    the dp axes and ``model``), ``conv_x`` and ``conv_bc`` whole over
    ``model`` (``d_conv - 1`` does not split).  The rank convolves its
    channels, and the new ``conv_x`` window is all-gathered whole before
    it is written.  Where the state's heads are not the rank's model
    heads (a batch of 1), the step's per-head inputs are gathered whole
    over ``model``, the recurrence runs on the state's heads, and its
    outputs are gathered back over ``head_axes``."""

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import spmd

    _check_groups(cfg, lay)
    mesh, r = lay.mesh, lay.model_index
    z = spmd.plain(xin, p["wz"], sp["wz"], lay)
    xu = spmd.plain(xin, p["wx"], sp["wx"], lay)
    dt = spmd.plain(xin, p["wdt"], sp["wdt"], lay)
    bc = spmd.plain(xin, p["wbc"], sp["wbc"], lay)
    di = xu.shape[-1]
    cx = state["conv_x"]
    xu, win = _causal_conv(xu, p["conv_w_x"], p["conv_b_x"], cfg.d_conv,
                           conv_state=cx.narrow(-1, r * di, di))
    win = C.all_gather(win, mesh, "model", 2)
    bc, conv_bc = _causal_conv(bc, p["conv_w_bc"], p["conv_b_bc"], cfg.d_conv,
                               conv_state=state["conv_bc"])
    b = xin.shape[0]
    gn = cfg.n_groups * cfg.d_state
    hm = di // cfg.headdim
    x = xu[:, 0].reshape(b, hm, cfg.headdim).float()
    dtv, A = _rates(p, dt[:, 0])
    dv = p["D"].float()
    hs = state["ssm"].shape[1]
    h0 = mesh.index(head_axes) * hs
    same = hs == hm and h0 == r * hm
    if not same:  # whole over model, then the state's heads
        x, dtv = (C.all_gather(t, mesh, "model", 1)[:, h0:h0 + hs] for t in (x, dtv))
        A, dv = (C.all_gather(t, mesh, "model", 0)[h0:h0 + hs] for t in (A, dv))
    Bh = bc[:, :, :gn].float().expand(b, hs, gn)                   # (B, H_s, N): one group
    Ch = bc[:, :, gn:].float().expand(b, hs, gn)
    decay = torch.exp(A[None] * dtv)
    h = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh * dtv[..., None], x)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    y = y + dv[None, :, None] * x
    if not same:  # back to the rank's model heads
        y = C.all_gather(y, mesh, head_axes, 1)[:, r * hm:(r + 1) * hm]
    out = _finalize_tp(p, sp, y[:, None], z, xin, lay)
    state["ssm"].copy_(h)
    state["conv_x"].copy_(win)
    state["conv_bc"].copy_(conv_bc)
    return out, state


__all__ = [
    "FP32_LEAVES",
    "SCANS",
    "SSMConfig",
    "apply_mamba2",
    "apply_mamba2_tp",
    "decode_mamba2",
    "decode_mamba2_tp",
    "init_mamba2",
    "init_mamba2_state",
    "reset_scans",
]
