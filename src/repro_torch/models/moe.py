"""Mixture-of-Experts FFN with capacity-based dispatch (the port's
``repro.models.moe``).

Top-k routing (Mixtral 8 x top-2; Qwen2-MoE 60 x top-4 plus a shared
expert) in the scatter/gather capacity formulation, step for step as the
reference computes it: tokens are grouped by batch row, each routing
decision is ranked inside its expert by a cumulative sum in token order
(the order of ``jnp.repeat(x, k, axis=1)``), decisions past the capacity
are dropped, and the kept tokens are scattered into per-expert capacity
buffers.  At decode (one token a row) the rows merge into groups of up to
256 tokens before routing, so the rows of a group share the capacity:
capacity routing couples the rows of a batch.

The work splits in three so that a caller can hold one route's dispatch
to another's routing:

  * :func:`route` — router logits (bf16 inputs, fp32 sums), softmax,
    top-k and its renormalisation: ``(gate_w, expert_idx, probs)``;
  * :func:`aux_loss` — the Switch-style load-balance loss of a routing;
  * :func:`combine` — dispatch, the expert products, gather, the shared
    expert with its sigmoid gate.

The expert products are batched matmuls (``torch.bmm``) over every expert,
as the reference computes them with ``jnp.einsum`` outside any Pallas
kernel; the shared expert's GLU goes through ``ops.gemm`` (the class's
GEMM kernel), as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import MoEConfig
from repro_torch.models import layers as L

# Rows merge into routing groups of at least this many tokens at decode.
MERGE_TOKENS = 256


def init_moe(generator: torch.Generator, cfg: MoEConfig, n_layers: int, *, device,
             dtype: torch.dtype = L.COMPUTE_DTYPE) -> dict:
    """Random MoE params stacked on a leading ``n_layers`` axis, at the
    reference's scales (router and shared gate 0.02, the rest ``dense_init``).

    The expert tensors are drawn one layer at a time into the stacked
    tensor, so the fp32 draw never holds more than one layer's experts
    (a full-width qwen2-moe layer's are 0.7 GB in fp32, the stack 25 GB
    in bf16)."""

    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert

    def stacked(shape, scale=None):
        out = torch.empty((n_layers,) + shape, dtype=dtype, device=device)
        for i in range(n_layers):
            out[i] = L.dense_init(generator, shape, scale, device=device, dtype=dtype)
        return out

    p = {
        "router": stacked((d, e), 0.02),
        "w1": stacked((e, d, f)),
        "w3": stacked((e, d, f)),
        "w2": stacked((e, f, d)),
    }
    if cfg.d_ff_shared:
        p["shared"] = {"w1": stacked((d, cfg.d_ff_shared)), "w3": stacked((d, cfg.d_ff_shared)),
                       "w2": stacked((cfg.d_ff_shared, d))}
        p["shared_gate"] = stacked((d, 1), 0.02)
    return p


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    c = ((c + 7) // 8) * 8
    # Never more slots than routing decisions (decode groups are small).
    return max(1, min(c if c else 1, tokens_per_group * cfg.top_k))


def _merge(b: int, s: int) -> int:
    """Rows merged into one routing group (the reference's rule): enough
    rows for ``MERGE_TOKENS`` tokens, stepped down to a divisor of ``b``."""

    if s >= MERGE_TOKENS or b <= 1:
        return 1
    merge = min(b, max(1, MERGE_TOKENS // max(s, 1)))
    while b % merge:
        merge -= 1
    return merge


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 values summed in fp32 (the reference's
    ``preferred_element_type=float32`` einsum)."""

    return torch.einsum("bsd,de->bse", x.to(L.COMPUTE_DTYPE).float(),
                        w.to(L.COMPUTE_DTYPE).float())


def route(p, x: torch.Tensor, cfg: MoEConfig):
    """x (G, S, D), one routing group a row -> ``(gate_w, expert_idx,
    probs)``: (G, S, k) fp32 renormalised top-k weights, (G, S, k) int64
    expert ids (descending probability), (G, S, E) fp32 probabilities."""

    probs = torch.softmax(_f32_product(x, p["router"]), dim=-1)
    gate_w, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return gate_w, expert_idx, probs


def aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance loss, per group, averaged over groups."""

    e = cfg.n_experts
    me = probs.mean(dim=1)                                    # (G, E)
    ce = torch.zeros_like(me)
    for j in range(cfg.top_k):
        ce = ce + F.one_hot(expert_idx[..., j].long(), e).float().mean(dim=1)
    return (me * ce).sum(-1).mean() * e * cfg.router_aux_weight


def positions(expert_idx: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """(G, S*k) rank of each routing decision inside its expert's buffer,
    counted in token order within the group."""

    g, s, k = expert_idx.shape
    flat_e = expert_idx.long().reshape(g, s * k)
    oh = F.one_hot(flat_e, cfg.n_experts)                    # (G, S*k, E)
    pos = torch.cumsum(oh, dim=1) - 1
    return pos.gather(-1, flat_e[..., None])[..., 0]


def dispatch(x: torch.Tensor, cfg: MoEConfig, gate_w: torch.Tensor, expert_idx: torch.Tensor):
    """Scatter ``x`` (G, S, D) into expert-major capacity buffers by the
    given routing: ``(buf (E, G*cap, D), (flat_e, rows, keep))``, the
    second part what :func:`gather_out` reads back."""

    g, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    cap = _capacity(s, cfg)
    xc = x.to(L.COMPUTE_DTYPE)
    flat_e = expert_idx.long().reshape(g, s * k)
    pos = positions(expert_idx, cfg)
    keep = (pos < cap).float() * gate_w.reshape(g, s * k)    # (G, S*k)
    pos_c = torch.clamp(pos, 0, cap - 1)

    # Expert-major capacity buffers: expert e's rows are (group, slot).
    rows = torch.arange(g, device=x.device)[:, None] * cap + pos_c      # (G, S*k)
    xr = xc.repeat_interleave(k, dim=1)                                 # (G, S*k, D)
    xr = xr * (keep > 0)[..., None].to(xr.dtype)
    buf = torch.zeros((e, g * cap, d), dtype=L.COMPUTE_DTYPE, device=x.device)
    # Each kept decision owns its (expert, slot); a dropped one adds zeros
    # to a clipped slot, so the sum is exact in any order.
    buf.index_put_((flat_e.reshape(-1), rows.reshape(-1)), xr.reshape(-1, d), accumulate=True)
    return buf, (flat_e, rows, keep)


def experts(buf: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """The experts' GLU over their buffers (bf16 weights, batched over E)."""

    h = F.silu(torch.bmm(buf, w1).float()).to(L.COMPUTE_DTYPE) * torch.bmm(buf, w3)
    return torch.bmm(h, w2)


def gather_out(out_buf: torch.Tensor, route_rows, g: int, s: int, k: int) -> torch.Tensor:
    """Each token's kept experts' outputs, weighted and summed: (G, S, D')."""

    flat_e, rows, keep = route_rows
    y = out_buf[flat_e, rows] * keep[..., None].to(L.COMPUTE_DTYPE)    # (G, S*k, D')
    return y.reshape(g, s, k, out_buf.shape[-1]).sum(dim=2)


def combine(p, x: torch.Tensor, cfg: MoEConfig, gate_w: torch.Tensor,
            expert_idx: torch.Tensor) -> torch.Tensor:
    """Dispatch ``x`` (G, S, D) by the given routing, run the experts and
    the shared expert, and gather: returns (G, S, D) in ``x``'s dtype."""

    g, s, _ = x.shape
    buf, route_rows = dispatch(x, cfg, gate_w, expert_idx)
    w = lambda name: p[name].to(L.COMPUTE_DTYPE)  # noqa: E731
    y = gather_out(experts(buf, w("w1"), w("w3"), w("w2")), route_rows, g, s, cfg.top_k)
    if cfg.d_ff_shared:
        xc = x.to(L.COMPUTE_DTYPE)
        gate = torch.sigmoid(_f32_product(xc, p["shared_gate"])).to(L.COMPUTE_DTYPE)
        y = y + gate * L.apply_glu(p["shared"], xc)
    return y.to(x.dtype)


def apply_moe(p, x: torch.Tensor, cfg: MoEConfig):
    """x (B, S, D) -> ``(y, aux_loss)``; groups are batch rows, merged at
    decode (see :func:`_merge`)."""

    b, s, d = x.shape
    merge = _merge(b, s)
    if merge > 1:
        y, aux = apply_moe(p, x.reshape(b // merge, merge * s, d), cfg)
        return y.reshape(b, s, d), aux
    gate_w, expert_idx, probs = route(p, x, cfg)
    return combine(p, x, cfg, gate_w, expert_idx), aux_loss(probs, expert_idx, cfg)


# ---------------------------------------------------------------------------
# A rank's part on a (data, model) mesh
# ---------------------------------------------------------------------------


def apply_moe_tp(p, sp, xn, cfg: MoEConfig, lay, *, seq: bool):
    """:func:`apply_moe` as a rank's part, by the reference's rules:
    ``router`` and ``shared_gate`` FSDP-only (gathered whole), the experts'
    ``w1`` / ``w3`` column-parallel on ``d_ff_expert`` and ``w2``
    row-parallel, their partial sums reduced over ``model`` (all-reduced,
    or under ``cfg.rs_output`` reduce-scattered over D, as the reference's
    ``constrain(out_buf, (None, None, None, "model"))`` pins it), the
    shared expert through :func:`layers.apply_glu_tp`.

    ``xn`` and the result are in the residual layout (``seq``: the
    sequence split over ``model``).  Routing groups are formed on the
    global batch: when a group of :func:`_merge` spans the dp ranks
    (decode, short sequences), the rows are all-gathered over the dp axes
    and every dp rank routes the whole batch, as GSPMD replicates a group
    dim the dp axes cannot split, and keeps its rows.  Returns ``(y,
    aux)``: ``aux`` this rank's term of the reference's mean over groups
    (the dp ranks' terms add up to it, ``spmd.dp_sum``)."""

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import spmd

    mesh, dp = lay.mesh, lay.dp
    n_dp = mesh.size(dp) if lay.rows_split else 1
    b, s_loc = xn.shape[:2]
    s = s_loc * (lay.model if seq else 1)
    merge = _merge(b * n_dp, s)
    gather_rows = n_dp > 1 and b % merge != 0
    x_rows = C.gather(xn, mesh, dp, 0) if gather_rows else xn
    # The router reads the stream whole over model, each model rank the
    # same: its gradient is whole on each (sliced back, not summed).
    x_route = C.gather(x_rows, mesh, "model", 1, grad="slice") if seq else x_rows
    x_exp = spmd.tp_enter(x_rows, lay, seq)
    bb, d = x_route.shape[0], x_route.shape[2]
    groups = bb // merge
    xg_route = x_route.reshape(groups, merge * s, d)
    xg = x_exp.reshape(groups, merge * s, d)

    router = spmd.use(p["router"].to(L.COMPUTE_DTYPE), sp["router"], lay)
    gate_w, expert_idx, probs = route({"router": router}, xg_route, cfg)
    aux = aux_loss(probs, expert_idx, cfg) / n_dp

    buf, route_rows = dispatch(xg, cfg, gate_w, expert_idx)
    w = {n: spmd.use(p[n].to(L.COMPUTE_DTYPE), sp[n], lay) for n in ("w1", "w3", "w2")}
    out_buf = experts(buf, w["w1"], w["w3"], w["w2"])            # partial over model
    flat_e, rows, keep = route_rows
    if cfg.rs_output and lay.model > 1:
        out_buf = C.scatter(out_buf, mesh, "model", 2)
        # The combine reads this rank's features: its gate gradients are
        # partial and summed over model.
        keep = C.enter(keep, mesh, "model")
        y = gather_out(out_buf, (flat_e, rows, keep), groups, merge * s, cfg.top_k)
        y = C.gather(y, mesh, "model", 2, grad="slice")
    else:
        y = gather_out(C.reduce(out_buf, mesh, "model"), route_rows, groups, merge * s,
                       cfg.top_k)
    y = y.reshape(bb, s, d)
    if seq:
        y = C.split(y, mesh, "model", 1)
    if gather_rows:
        y = C.local_block(y, mesh, dp, 0)
    if cfg.d_ff_shared:
        gw = spmd.use(p["shared_gate"].to(L.COMPUTE_DTYPE), sp["shared_gate"], lay)
        gw = spmd.norm_weight(gw, lay, seq)
        gate = torch.sigmoid(_f32_product(xn, gw)).to(L.COMPUTE_DTYPE)
        y = y + gate * L.apply_glu_tp(p["shared"], sp["shared"], xn, lay, seq=seq)
    return y.to(xn.dtype), aux


def moe_active_params(cfg: MoEConfig) -> int:
    """Per-token active parameter count (routed top-k, router, shared)."""

    expert = 3 * cfg.d_model * cfg.d_ff_expert
    n = cfg.top_k * expert + cfg.d_model * cfg.n_experts
    if cfg.d_ff_shared:
        n += 3 * cfg.d_model * cfg.d_ff_shared + cfg.d_model
    return n


__all__ = [
    "MERGE_TOKENS",
    "MoEConfig",
    "aux_loss",
    "apply_moe",
    "apply_moe_tp",
    "combine",
    "dispatch",
    "experts",
    "gather_out",
    "init_moe",
    "moe_active_params",
    "positions",
    "route",
]
