"""The Mamba2 chunked SSD scan for Hopper (CUDA C++), forward and backward.

The port's hand-written counterpart of ``models.ssm._ssd_chunked`` (the
reference scans in ``jnp`` operations, with no Pallas kernel): the same
contract, ``(y in x's dtype, final state (B, H, N, P) fp32)`` from x (B,
S, H, P), the post-softplus dt (B, S, H), the negative rates A (H,) and
B, C (B, S, G, N), with an optional entering state.  Three functions
compute it:

  * :func:`ssd_scan_cuda` — the kernels (``csrc/ssd_scan.cu``).  The
    forward is three launches: ``ssd_cb`` (``C · Bᵀ`` once per chunk and
    group, fp32), ``ssd_state_fwd`` (one block per row and head walking
    the chunks: the decay's running sum ``l``, each chunk's state and the
    state passed on, held in fp32 registers) and ``ssd_chunk_scan`` (each
    64-row tile's output, the intra-chunk product and the entering
    state's).  With grad mode on and an input requiring grad it runs
    :class:`SsdScanFn`, which saves x, A, B, C and one workspace (``C ·
    Bᵀ``, ``l``, dt by head, the entering states: :func:`_workspace`), and
    whose backward is six more launches of the same source
    (``ssd_bwd_state``, ``ssd_bwd_dcb``, ``ssd_bwd_dx``, ``ssd_bwd_dbdc``,
    ``ssd_bwd_dt``, ``ssd_bwd_reduce``) on one scratch workspace.  No sum
    crosses blocks by atomics: the heads of a group are summed in a fixed
    order, so the gradients are the same bits call after call.  B and C
    are read in place where they are rows of one stride (the model's
    slices of the ``wbc`` projection).
  * :func:`ssd_fwd_torch` and :func:`ssd_bwd_torch` — the plain versions,
    the oracle the kernels are held to: the same stages with the same
    arithmetic.  Everything the configuration keeps in fp32 is fp32 (the
    decays, their running sums and exponentials, the states, every sum,
    the gradients of dt and A); x, B, C and the output's gradient enter
    the products as the bf16 values they are; an fp32 quantity that enters
    a product (the decay-weighted scores and x, the states, the weighted C,
    the gradients of the states and of ``C · Bᵀ``) enters as a bf16 high
    and low pair, two products that keep about 16 bits of it (:func:`split`).

Shapes the kernels take (:func:`kernel_takes`): bf16 x, B, C and fp32 dt,
A on one CUDA device; headdim 64; d_state 64 or 128; a chunk of 64, 128 or
256 that divides the sequence; groups that divide the heads; an entering
state that is not differentiated.  ``models.ssm._scan`` routes everything
else to ``_ssd_chunked``.  ``LAUNCHES`` counts :func:`ssd_scan_cuda` calls
and each kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

HEADDIM = 64
D_STATES = (64, 128)
CHUNKS = (64, 128, 256)
TILE = 64            # positions per tile of a chunk, as csrc/ssd_scan.cu's kT
HEADS_PER_SPLIT = 8  # the most heads one block of ssd_bwd_dbdc sums

FWD_KERNELS = ("ssd_cb", "ssd_state_fwd", "ssd_chunk_scan")
BWD_KERNELS = ("ssd_bwd_state", "ssd_bwd_dcb", "ssd_bwd_dx", "ssd_bwd_dbdc", "ssd_bwd_dt",
               "ssd_bwd_reduce")
LAUNCHES: dict[str, int] = {"ssd_scan_cuda": 0, **{k: 0 for k in FWD_KERNELS + BWD_KERNELS}}
_DTYPES = (torch.bfloat16,) * 3 + (torch.float32,) * 2   # x, B, C; dt, A


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_takes(x, dt, A, Bm, Cm, chunk: int, init_state=None) -> bool:
    """Whether :func:`ssd_scan_cuda` takes this call: what the kernels
    were built for, read off the inputs alone."""

    if (x.dtype, Bm.dtype, Cm.dtype, dt.dtype, A.dtype) != _DTYPES or not x.is_cuda:
        return False
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        return False
    if x.ndim != 4 or Bm.ndim != 4 or Cm.shape != Bm.shape:
        return False
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(chunk, s)
    if p != HEADDIM or n not in D_STATES or q not in CHUNKS or s % q or h % g:
        return False
    if init_state is not None:
        if init_state.requires_grad and torch.is_grad_enabled():
            return False
        if init_state.device != x.device or tuple(init_state.shape) != (b, h, n, p):
            return False
    return True


def heads_per_split(rep: int) -> int:
    """Heads of a group that one ``ssd_bwd_dbdc`` block sums: the largest
    divisor of ``rep`` up to ``HEADS_PER_SPLIT``."""

    return max(d for d in range(1, min(rep, HEADS_PER_SPLIT) + 1) if rep % d == 0)


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def split(v: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the kernels multiply it: its bf16 high part plus
    the bf16 rounding of what is left, summed back in fp32."""

    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def _dims(x, Bm, chunk):
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    return b, s, h, p, g, n, q, s // q, h // g


def _stages(x, dt, A, Bm, Cm, chunk, init_state):
    """The forward's stages in fp32: every intermediate the backward reads."""

    b, s, h, p, g, n, q, nc, rep = _dims(x, Bm, chunk)
    xq = x.reshape(b, nc, q, h, p).float()
    dtq = dt.reshape(b, nc, q, h).float()
    bq = Bm.reshape(b, nc, q, g, n).float()
    cq = Cm.reshape(b, nc, q, g, n).float()
    bh, ch = bq.repeat_interleave(rep, dim=3), cq.repeat_interleave(rep, dim=3)  # (B, nc, Q, H, N)

    # ssd_cb: C · Bᵀ once per chunk and group.
    cb = torch.einsum("bctgn,bcsgn->bcgts", cq, bq)                           # (B, nc, G, Q, Q)
    # ssd_state_fwd: the running sum of A·dt in each chunk, the chunk's state
    # sum_s exp(l_Q - l_s) dt_s B_s ⊗ x_s, and the states passed on.
    l = torch.cumsum(A.float() * dtq, dim=2)                                   # (B, nc, Q, H)
    w = torch.exp(l[:, :, -1:] - l) * dtq
    sc = torch.einsum("bcshn,bcshp->bchnp", bh, split(w[..., None] * xq))
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device))
    states = []
    for c in range(nc):
        states.append(state)
        state = torch.exp(l[:, c, -1])[..., None, None] * state + sc[:, c]
    states = torch.stack(states, dim=1)                                        # (B, nc, H, N, P)
    # The decays exp(l_t - l_s) below the diagonal, masked before the
    # exponential (above it the difference is positive and may overflow).
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    seg = l[:, :, :, None, :] - l[:, :, None, :, :]                            # (B, nc, T, S, H)
    decay = torch.exp(torch.where(causal, seg, torch.full((), -torch.inf, device=x.device)))
    cbh = cb.permute(0, 1, 3, 4, 2).repeat_interleave(rep, dim=4)              # (B, nc, T, S, H)
    m = cbh * decay * dtq[:, :, None, :, :]
    return dict(dims=(b, s, h, p, g, n, q, nc, rep), xq=xq, dtq=dtq, bq=bq, cq=cq, bh=bh, ch=ch,
                cb=cb, cbh=cbh, l=l, w=w, states=states, final=state, decay=decay, m=m)


def ssd_fwd_torch(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Plain version of the forward kernels, on any device: ``(y in x's
    dtype, final state fp32)``.  ``ssd_chunk_scan``'s output is the
    entering state's part ``exp(l_t) · C_t · state`` plus the masked,
    decay-weighted scores times x, both products with the fp32 operand
    split (:func:`split`)."""

    st = _stages(x, dt, A, Bm, Cm, chunk, init_state)
    b, s, h, p = st["dims"][:4]
    inter = torch.einsum("bcthn,bchnp->bcthp", st["ch"], split(st["states"]))
    y = torch.exp(st["l"])[..., None] * inter
    y = y + torch.einsum("bctsh,bcshp->bcthp", split(st["m"]), st["xq"])
    return y.reshape(b, s, h, p).to(x.dtype), st["final"]


def ssd_bwd_torch(x, dt, A, Bm, Cm, chunk: int, dy, dfinal=None, init_state=None):
    """Plain version of the backward kernels, on any device: ``(dx, ddt,
    dA, dB, dC, d_init)`` for the output's gradient ``dy`` and the final
    state's ``dfinal`` (None reads as zeros); dx, dB and dC in their
    inputs' dtypes, the rest fp32.  Stage by stage:

      * ``ssd_bwd_state``: the chunks walked backwards carrying G, the
        gradient of the state leaving a chunk: the chunk's state gradient
        is G, the decay's ``D_c <G, h_c>`` (h_c as its planes hold it), then
        ``G = D_c G + (exp(l) ∘ C)ᵀ · dy``;
      * ``ssd_bwd_dcb``: ``dCB = Σ_heads (dy · xᵀ) ∘ L ∘ dt`` per group;
      * ``ssd_bwd_dx``: dx from the scores' transpose and from the chunk's
        state, each position's dt terms and its share of dl;
      * ``ssd_bwd_dbdc``: dB and dC summed over the group's heads, and the
        entering state's part of dl;
      * ``ssd_bwd_dt``: dl summed backwards within the chunk into the
        gradient of ``A·dt``, then ddt and dA.
    """

    st = _stages(x, dt, A, Bm, Cm, chunk, init_state)
    b, s, h, p, g, n, q, nc, rep = st["dims"]
    xq, dtq, bq, cq, bh, ch = (st[k] for k in ("xq", "dtq", "bq", "cq", "bh", "ch"))
    l, w, states, decay, m, cbh = (st[k] for k in ("l", "w", "states", "decay", "m", "cbh"))
    dyq = dy.reshape(b, nc, q, h, p).float()
    ew = torch.exp(l)                                                          # (B, nc, Q, H)
    last = torch.exp(l[:, :, -1])                                              # (B, nc, H)

    # ssd_bwd_state
    dh = torch.einsum("bcthn,bcthp->bchnp", split(ew[..., None] * ch), dyq)
    carry = (dfinal.float() if dfinal is not None
             else torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device))
    dsc, ddecay = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dsc[c] = carry
        ddecay[c] = last[:, c] * (carry * split(states[:, c])).sum((-2, -1))
        carry = last[:, c][..., None, None] * carry + dh[:, c]
    dsc, ddecay = torch.stack(dsc, dim=1), torch.stack(ddecay, dim=1)         # (B, nc, H, N, P), (B, nc, H)

    # ssd_bwd_dcb
    dm = torch.einsum("bcthp,bcshp->bctsh", dyq, xq)                           # (B, nc, T, S, H)
    dmw = dm * decay * dtq[:, :, None, :, :]
    dcb = dmw.reshape(b, nc, q, q, g, rep).sum(-1)                             # (B, nc, T, S, G)

    # ssd_bwd_dx
    bds = torch.einsum("bcshn,bchnp->bcshp", bh, split(dsc))
    dx = torch.einsum("bctsh,bcthp->bcshp", split(m), dyq) + w[..., None] * bds
    r = dm * m
    dw = (xq * bds).sum(-1)                                                    # (B, nc, S, H)
    ddt = (dm * cbh * decay).sum(2) + dw * torch.exp(l[:, :, -1:] - l)
    dww = dw * w

    # ssd_bwd_dbdc
    dcraw = torch.einsum("bcthp,bchnp->bcthn", dyq, split(states))
    dli = ew * (ch * dcraw).sum(-1)
    dc = (ew[..., None] * dcraw).reshape(b, nc, q, g, rep, n).sum(4)
    dc = dc + torch.einsum("bctsg,bcsgn->bctgn", split(dcb), bq)
    db = (w[..., None] * torch.einsum("bcshp,bchnp->bcshn", xq, split(dsc))).reshape(
        b, nc, q, g, rep, n).sum(4)
    db = db + torch.einsum("bctsg,bctgn->bcsgn", split(dcb), cq)

    # ssd_bwd_dt
    dl = r.sum(3) - r.sum(2) + dli - dww
    dl[:, :, -1] += dww.sum(2) + ddecay
    da = torch.flip(torch.cumsum(torch.flip(dl, (2,)), dim=2), (2,))
    ddt = ddt + A.float() * da
    dA = (dtq * da).sum((0, 1, 2))
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.reshape(b, s, h), dA,
            db.reshape(b, s, g, n).to(Bm.dtype), dc.reshape(b, s, g, n).to(Cm.dtype), carry)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_FNS: dict = {}
# C entry point -> (pointer arguments, int arguments); the stream last.
_ENTRIES = {"repro_ssd_fwd": (12, 7), "repro_ssd_bwd": (26, 8)}


def _kernel(entry: str):
    fn = _FNS.get(entry)
    if fn is None:
        from repro_torch.kernels import build

        fn = getattr(build.load("ssd_scan"), entry)
        ptrs, ints = _ENTRIES[entry]
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return fn


@functools.lru_cache(maxsize=64)
def _workspace(b: int, s: int, h: int, g: int, n: int, q: int, backward: bool):
    """Byte offsets of the intermediates in one workspace, each 256-byte
    aligned, and its size.  The forward's: ``cb`` (B, nc, G, Q, Q), ``l``
    and ``dth`` (dt by head) (B, H, S), fp32; ``states``, the entering
    states' bf16 high and low planes (B, nc, H, 2, N, P).  The backward's
    scratch: ``dsc`` (as states), ``ddecay`` and ``dapart`` (B, H, nc),
    ``dcb`` (as cb), ``rowpart`` (B, H, S, Q / 64), ``ddtd``, ``dlc``,
    ``dww`` and ``dli`` (B, H, S), ``dbpart`` and ``dcpart`` (B, S, splits +
    1, G, N), fp32."""

    nc = s // q
    planes = 2 * b * nc * h * 2 * n * HEADDIM
    if backward:
        slots = h // g // heads_per_split(h // g) + 1
        parts = [("dsc", planes), ("ddecay", 4 * b * h * nc), ("dcb", 4 * b * nc * g * q * q),
                 ("rowpart", 4 * b * h * s * (q // TILE))]
        parts += [(k, 4 * b * h * s) for k in ("ddtd", "dlc", "dww", "dli")]
        parts += [(k, 4 * b * s * slots * g * n) for k in ("dbpart", "dcpart")]
        parts += [("dapart", 4 * b * h * nc)]
    else:
        parts = [("cb", 4 * b * nc * g * q * q), ("l", 4 * b * h * s), ("dth", 4 * b * h * s),
                 ("states", planes)]
    offsets, total = {}, 0
    for name, nbytes in parts:
        offsets[name] = total
        total += -(-nbytes // 256) * 256
    return offsets, total


def _launch(entry: str, ptrs: list, ints: list, device, what: str) -> None:
    """One C entry point's launches on ``device``'s current stream (the
    device made current for them only where it is not already)."""

    from repro_torch.kernels import build

    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        status = _kernel(entry)(*ptrs, *ints, stream)
    else:
        with torch.cuda.device(device):
            status = _kernel(entry)(*ptrs, *ints, stream)
    build.check(status, what)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels read it."""

    if not t.is_contiguous():
        t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _rows(Bm, Cm):
    """B and C as the kernels read them: in place where both are rows of
    one stride (a multiple of 8 elements, 16-byte aligned, each row's
    groups contiguous: the model's slices of the ``wbc`` projection), else
    contiguous copies; and that stride."""

    b, s, g, n = Bm.shape
    ld = Bm.stride(1)
    strided = (Bm.stride() == Cm.stride() == (s * ld, ld, n, 1) and ld % 8 == 0
               and Bm.data_ptr() % 16 == 0 and Cm.data_ptr() % 16 == 0)
    if strided:
        return Bm, Cm, ld
    return _dense(Bm), _dense(Cm), g * n


def _forward(x, dt, A, Bm, Cm, ld_bc: int, chunk: int, init_state):
    """The three forward launches: ``y``, the final state and the workspace
    the backward reads (:func:`_workspace`)."""

    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(chunk, s)
    offsets, total = _workspace(b, s, h, g, n, q, False)
    ws = torch.empty(total, dtype=torch.uint8, device=x.device)
    y = torch.empty_like(x)
    final = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    base = ws.data_ptr()
    _launch("repro_ssd_fwd",
            [x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if init_state is None else init_state.data_ptr(), y.data_ptr(), final.data_ptr()]
            + [base + offsets[k] for k in ("cb", "l", "dth", "states")],
            [b, s, h, g, n, q, ld_bc], x.device,
            f"ssd_scan_cuda's forward B={b} S={s} H={h} G={g} N={n} Q={q}")
    LAUNCHES["ssd_scan_cuda"] += 1
    for k in FWD_KERNELS:
        LAUNCHES[k] += 1
    return y, final, ws


def _backward(x, A, Bm, Cm, ld_bc: int, chunk: int, ws, dy, dfinal):
    """The six backward launches: ``(dx, ddt, dA, dB, dC)``."""

    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(chunk, s)
    saved, _ = _workspace(b, s, h, g, n, q, False)
    offsets, total = _workspace(b, s, h, g, n, q, True)
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    dA = torch.empty((h,), dtype=torch.float32, device=x.device)
    dB = torch.empty((b, s, g, n), dtype=Bm.dtype, device=x.device)
    dC = torch.empty((b, s, g, n), dtype=Cm.dtype, device=x.device)
    wp, sp = ws.data_ptr(), scratch.data_ptr()
    _launch("repro_ssd_bwd",
            [x.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr()]
            + [wp + saved[k] for k in ("cb", "l", "dth", "states")]
            + [dy.data_ptr(), None if dfinal is None else dfinal.data_ptr()]
            + [sp + offsets[k] for k in ("dsc", "ddecay", "dcb", "rowpart", "ddtd", "dlc", "dww",
                                          "dli", "dbpart", "dcpart", "dapart")]
            + [t.data_ptr() for t in (dx, ddt, dA, dB, dC)],
            [b, s, h, g, n, q, heads_per_split(h // g), ld_bc], x.device,
            f"ssd_scan_cuda's backward B={b} S={s} H={h} G={g} N={n} Q={q}")
    for k in BWD_KERNELS:
        LAUNCHES[k] += 1
    return dx, ddt, dA, dB, dC


class SsdScanFn(torch.autograd.Function):
    """The differentiable scan: the forward kernels, saving x, A, B, C and
    the workspace (``C · Bᵀ``, ``l``, dt by head, the entering states); the
    backward kernels.  The entering state is not differentiated."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, ld_bc, chunk, init_state):
        y, final, ws = _forward(x, dt, A, Bm, Cm, ld_bc, chunk, init_state)
        ctx.save_for_backward(x, A, Bm, Cm, ws)
        ctx.scan = (ld_bc, chunk)
        ctx.set_materialize_grads(False)   # an unused final state's gradient stays None
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, A, Bm, Cm, ws = ctx.saved_tensors
        ld_bc, chunk = ctx.scan
        dy = torch.zeros_like(x) if dy is None else _dense(dy.to(x.dtype))
        dfinal = None if dfinal is None else _dense(dfinal.float())
        dx, ddt, dA, dB, dC = _backward(x, A, Bm, Cm, ld_bc, chunk, ws, dy, dfinal)
        return dx, ddt, dA, dB, dC, None, None, None


def ssd_scan_cuda(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """The chunked SSD scan through the CUDA kernels, with
    ``_ssd_chunked``'s contract: ``(y in x's dtype, final state (B, H, N,
    P) fp32)``.  Raises for a call :func:`kernel_takes` refuses (no
    fallback).  With grad mode on and an input requiring grad, the call is
    :class:`SsdScanFn`; otherwise the forward alone, keeping nothing."""

    if not kernel_takes(x, dt, A, Bm, Cm, chunk, init_state):
        raise ValueError(
            f"ssd_scan_cuda takes bf16 x, B, C and fp32 dt, A on one CUDA device, headdim "
            f"{HEADDIM}, d_state in {D_STATES}, a chunk in {CHUNKS} dividing the sequence and an "
            f"entering state not differentiated: got x {tuple(x.shape)} {x.dtype} {x.device}, B "
            f"{tuple(Bm.shape)} {Bm.dtype}, dt {dt.dtype}, A {A.dtype}, chunk {chunk}")
    x, dt, A = _dense(x), _dense(dt), _dense(A)
    Bm, Cm, ld_bc = _rows(Bm, Cm)
    init = None if init_state is None else _dense(init_state.detach().float())
    if torch.is_grad_enabled() and (x.requires_grad or dt.requires_grad or A.requires_grad
                                    or Bm.requires_grad or Cm.requires_grad):
        return SsdScanFn.apply(x, dt, A, Bm, Cm, ld_bc, chunk, init)
    y, final, _ = _forward(x, dt, A, Bm, Cm, ld_bc, chunk, init)
    return y, final


__all__ = [
    "BWD_KERNELS",
    "CHUNKS",
    "D_STATES",
    "FWD_KERNELS",
    "HEADDIM",
    "LAUNCHES",
    "SsdScanFn",
    "heads_per_split",
    "kernel_takes",
    "reset_launches",
    "split",
    "ssd_bwd_torch",
    "ssd_fwd_torch",
    "ssd_scan_cuda",
]
