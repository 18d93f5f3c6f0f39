"""The SSD scan kernels (``csrc/ssd_scan.cu``) on a card.

``ssd_scan_cuda``'s output, final state and five gradients are held to
``ssd_fwd_torch`` / ``ssd_bwd_torch`` (the kernels' arithmetic in plain
PyTorch, fp32 on the card) and to ``_ssd_chunked`` and its autograd (the
route before), at the benchmark cell's layer (4 x 2,048, 64 heads of 64,
d_state 128, one group, chunk 256) at three seeds, at zamba2's d_state 64
(80 heads), and with an entering state.  Relative L2 errors: the fp32
outputs (the final state, ddt, dA) within ``FP32_TOL`` = 1e-4 (readings
about 3e-6: the operands' high and low pairs, sums in other orders); the
bf16 outputs (y, dx, dB, dC) within ``BF16_TOL`` = 1e-3 (readings about
1e-4: a value whose fp32 sum lands on the other side of a bf16 rounding
boundary moves by one bf16 step).  Two backward runs give the same bits;
every input the kernels do not take goes to ``_ssd_chunked`` and is counted
in ``layers.CUDA_CALLS["ssd_chunked"]``.

Marked ``cuda``; skips without a card.  The file imports neither ``jax``
nor the JAX package; on the card's machine run it without the conftest::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_ssd.py
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.configs import SSMConfig
from repro_torch.kernels import ssd as SSD
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

FP32_TOL = 1e-4
BF16_TOL = 1e-3

# (rows, seq, heads, groups, d_state, chunk, entering state, seed); an even
# seed draws B and C as the model does, slices of one projection's rows (the
# kernels read them in place), an odd one as contiguous tensors.
CELL = (4, 2048, 64, 1, 128, 256, False)
CASES = [CELL + (1,), CELL + (2,), CELL + (3,),
         (2, 2048, 80, 1, 64, 256, False, 4),     # zamba2's Mamba layers
         (2, 1024, 64, 1, 128, 256, True, 5),     # a prefill from a carried state
         (1, 512, 8, 2, 64, 128, True, 6),        # two groups, chunk 128
         (2, 256, 4, 1, 128, 64, False, 7)]       # chunk 64
IDS = [f"b{b}-s{s}-h{h}-g{g}-n{n}-q{q}-{'init' if i else 'zero'}-{'bc' if sd % 2 == 0 else 'dense'}-seed{sd}"
       for b, s, h, g, n, q, i, sd in CASES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(case, dev):
    """bf16 x, B, C and output gradient; fp32 dt = exp(U(log 1e-4, log
    0.1)) and A = -U(1, 16), the published ranges; an fp32 entering state
    and final-state gradient."""

    b, s, h, g, n, q, init, seed = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    x, dy = bf(b, s, h, 64), bf(b, s, h, 64)
    if seed % 2 == 0:
        bc = bf(b, s, 2 * g * n)
        Bm, Cm = bc[..., :g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n)
    else:
        Bm, Cm = bf(b, s, g, n), bf(b, s, g, n)
    A = -(1.0 + 15.0 * torch.rand(h, generator=gen, device=dev))
    u = torch.rand((b, s, h), generator=gen, device=dev)
    dt = torch.exp(math.log(1e-4) + (math.log(0.1) - math.log(1e-4)) * u)
    h0 = torch.randn((b, h, n, 64), generator=gen, device=dev) if init else None
    dfinal = torch.randn((b, h, n, 64), generator=gen, device=dev)
    return x, dt, A, Bm, Cm, h0, dy, dfinal


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _kernel_run(x, dt, A, Bm, Cm, q, h0, dy, dfinal):
    """The kernels' output, final state and gradients; B and C drawn as
    slices of one tensor are differentiated as such slices."""

    ins = [t.clone().requires_grad_(True) for t in (x, dt, A)]
    b, s, g, n = Bm.shape
    if Bm.is_contiguous():
        bm, cm = (t.clone().requires_grad_(True) for t in (Bm, Cm))
        leaves = [bm, cm]
    else:
        bc = torch.cat([Bm.flatten(2), Cm.flatten(2)], dim=-1).requires_grad_(True)
        bm, cm = bc[..., :g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n)
        leaves = [bc]
    y, final = SSD.ssd_scan_cuda(*ins, bm, cm, q, init_state=h0)
    torch.autograd.backward([y, final], [dy, dfinal])
    if len(leaves) == 2:
        db, dc = bm.grad, cm.grad
    else:
        db, dc = (leaves[0].grad[..., sl].reshape(b, s, g, n) for sl in (slice(0, g * n), slice(g * n, None)))
    return y.detach(), final.detach(), [t.grad for t in ins] + [db, dc]


def _check(name, got, want, readings):
    tol = FP32_TOL if got.dtype == torch.float32 else BF16_TOL
    err = _rel(got, want)
    readings[name] = err
    return err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_ssd_matches_plain_and_chunked(cuda, case):
    x, dt, A, Bm, Cm, h0, dy, dfinal = _inputs(case, cuda)
    q = case[5]
    SSD.reset_launches()
    y, final, grads = _kernel_run(x, dt, A, Bm, Cm, q, h0, dy, dfinal)
    assert SSD.LAUNCHES["ssd_scan_cuda"] == 1
    assert all(SSD.LAUNCHES[k] == 1 for k in SSD.FWD_KERNELS + SSD.BWD_KERNELS)

    names = ["dx", "ddt", "dA", "dB", "dC"]
    y_p, final_p = SSD.ssd_fwd_torch(x, dt, A, Bm, Cm, q, h0)
    grads_p = SSD.ssd_bwd_torch(x, dt, A, Bm, Cm, q, dy, dfinal, h0)[:5]
    cfg = SSMConfig(d_model=case[2] * 32, d_state=case[4], headdim=64, chunk=q)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y_c, final_c = S._ssd_chunked(*ins, cfg, init_state=h0)
    torch.autograd.backward([y_c, final_c], [dy, dfinal])
    grads_c = [t.grad for t in ins]

    readings, ok = {"plain": {}, "chunked": {}}, True
    for ref, yr, fr, gr in (("plain", y_p, final_p, grads_p), ("chunked", y_c, final_c, grads_c)):
        ok &= _check("y", y, yr, readings[ref])
        ok &= _check("final", final, fr, readings[ref])
        for k, g, w in zip(names, grads, gr):
            assert g.dtype == w.dtype and g.shape == w.shape
            ok &= _check(k, g, w, readings[ref])
    print({ref: {k: f"{v:.2e}" for k, v in r.items()} for ref, r in readings.items()})
    assert ok, readings


@pytest.mark.cuda
def test_cuda_ssd_gradients_are_the_same_bits_twice(cuda):
    x, dt, A, Bm, Cm, h0, dy, dfinal = _inputs(CASES[0], cuda)
    first = _kernel_run(x, dt, A, Bm, Cm, 256, h0, dy, dfinal)
    second = _kernel_run(x, dt, A, Bm, Cm, 256, h0, dy, dfinal)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert all(torch.equal(a, b) for a, b in zip(first[2], second[2]))


@pytest.mark.cuda
def test_cuda_ssd_forward_without_grad_launches_the_forward_alone(cuda):
    x, dt, A, Bm, Cm, h0, dy, dfinal = _inputs(CASES[4], cuda)
    y, final, _ = _kernel_run(x, dt, A, Bm, Cm, 256, h0, dy, dfinal)
    SSD.reset_launches()
    with torch.no_grad():
        y2, final2 = SSD.ssd_scan_cuda(x, dt, A, Bm, Cm, 256, init_state=h0)
    assert torch.equal(y, y2) and torch.equal(final, final2)
    assert all(SSD.LAUNCHES[k] == 1 for k in SSD.FWD_KERNELS)
    assert all(SSD.LAUNCHES[k] == 0 for k in SSD.BWD_KERNELS)


def _fallbacks(dev):
    """Inputs the kernels do not take, each with the reason."""

    x, dt, A, Bm, Cm, h0, _, _ = _inputs((1, 512, 8, 1, 128, 256, True, 8), dev)
    cfg = SSMConfig(d_model=256, d_state=128, headdim=64, chunk=256)
    narrow = SSMConfig(d_model=128, d_state=128, headdim=32, chunk=256)
    odd = SSMConfig(d_model=256, d_state=96, headdim=64, chunk=256)
    long_chunk = SSMConfig(d_model=256, d_state=128, headdim=64, chunk=512)
    return {
        "fp32 x": (x.float(), dt, A, Bm, Cm, cfg, None),
        "fp32 B and C (the sharded block's)": (x, dt, A, Bm.float(), Cm.float(), cfg, None),
        "bf16 dt": (x, dt.to(torch.bfloat16), A, Bm, Cm, cfg, None),
        "headdim 32": (x.reshape(1, 512, 16, 32), dt.repeat(1, 1, 2), A.repeat(2), Bm, Cm, narrow,
                       None),
        "d_state 96": (x, dt, A, Bm[..., :96], Cm[..., :96], odd, None),
        "chunk 512": (x, dt, A, Bm, Cm, long_chunk, None),
        "an entering state to differentiate": (x, dt, A, Bm, Cm, cfg, h0.requires_grad_(True)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["fp32 x", "fp32 B and C (the sharded block's)", "bf16 dt",
                                  "headdim 32", "d_state 96", "chunk 512",
                                  "an entering state to differentiate"])
def test_cuda_scan_falls_back_where_the_kernels_do_not_take_it(cuda, what):
    x, dt, A, Bm, Cm, cfg, h0 = _fallbacks(cuda)[what]
    SSD.reset_launches()
    before = L.CUDA_CALLS["ssd_chunked"]
    with torch.enable_grad():
        y, final = S._scan(x, dt, A, Bm, Cm, cfg, init_state=h0)
    assert SSD.LAUNCHES["ssd_scan_cuda"] == 0
    assert L.CUDA_CALLS["ssd_chunked"] == before + 1
    y_ref, final_ref = S._ssd_chunked(x, dt, A, Bm, Cm, cfg, init_state=h0)
    assert torch.equal(y, y_ref) and torch.equal(final, final_ref)


@pytest.mark.cuda
def test_cuda_scan_takes_the_kernels_at_the_cell_shapes(cuda):
    x, dt, A, Bm, Cm, h0, dy, dfinal = _inputs((1, 512, 64, 1, 128, 256, True, 9), cuda)
    cfg = SSMConfig(d_model=2048, d_state=128, headdim=64, chunk=256)
    SSD.reset_launches()
    before = L.CUDA_CALLS["ssd_chunked"]
    S._scan(x, dt, A, Bm, Cm, cfg, init_state=h0)
    zamba = dataclasses.replace(cfg, d_state=64)
    S._scan(x, dt, A, Bm[..., :64], Cm[..., :64], zamba)
    assert SSD.LAUNCHES["ssd_scan_cuda"] == 2
    assert L.CUDA_CALLS["ssd_chunked"] == before
