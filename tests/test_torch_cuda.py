"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every kernel test here is marked ``cuda`` and skips without a card (the
kernels have no CPU mode; ``test_torch_kernels.py`` holds the plain
versions against the JAX package here); the unmarked tests calibrate
the row checks (paged and flash attention, the GEMM) on the CPU.  The file imports neither ``jax`` nor the
JAX package, so it also runs on a machine with only PyTorch and ``nvcc``;
``tests/conftest.py`` imports jax, so run it there without the conftest::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: bf16 outputs rtol = atol = 2e-2 and fp32 outputs 1e-4, as in
``tests/test_backend_parity.py`` (the kernels and the plain versions both
accumulate in fp32, in other orders: the kernels on the tensor cores).
The lean GEMM equals the pipelined one bitwise at equal blocks.  Flash
attention is held to its plain version at the bf16 tolerance: both round
``p`` to bf16 before ``p · V`` and sum in fp32, in other orders.  Its rows
must also lie within ``FLASH_ROW_TOL`` of the plain version's in L2,
relative to the row's own norm: late causal rows average thousands of
values down to a few hundredths, where the bf16 tolerance's absolute 0.02
would pass a row that lost a key block.  The GEMM autograd Function's
output and gradients (unit-scale cotangents) are held row by row in L2
within ``GEMM_ROW_TOL`` too: a product that skipped one K-tile of its
reduction moves a row by ``sqrt(bk / K)`` of its norm.  The flash
backward's dQ, dK and dV are held to its plain version row by row within
``FLASH_ROW_TOL`` of the larger of the row's norm and the gradient's mean
row norm (:func:`grad_row_err`): a query that sees one key has a dQ row of
rounding noise (``P = 1``, ``dS = 0``), and a late key few queries see a
small dK row.
"""

import contextlib
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import execution as X
from repro_torch.core.blocking import BM_TILES, BN_TILES, BlockConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gemm as G
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime.paging import SENTINEL

BF16 = dict(rtol=2e-2, atol=2e-2)
FP32 = dict(rtol=1e-4, atol=1e-4)
FLASH_ROW_TOL = 2e-2
GEMM_ROW_TOL = 1e-2


def row_rel_err(got, ref):
    """The largest ``|got - ref| / |ref|`` over the rows (last axis) in L2."""

    diff = (got.float() - ref.float()).norm(dim=-1)
    return float((diff / ref.float().norm(dim=-1).clamp_min(1e-30)).max())


def grad_row_err(got, ref):
    """The largest ``|got - ref|`` over the rows (last axis) in L2, over the
    larger of the row's norm and the mean row norm of ``ref``."""

    diff = (got.float() - ref.float()).norm(dim=-1)
    norms = ref.float().norm(dim=-1)
    return float((diff / norms.clamp_min(float(norms.mean()))).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    return torch.device("cuda")


def _operands(cuda, m, k, n, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = (torch.randn((k, n), generator=gen, device=cuda) / math.sqrt(k)).bfloat16()
    return a, b


# Decode shapes (M = 12): internlm2-1.8b's, qwen2-moe-a2.7b's shared expert
# (K = 5632 = 44 x 128) and LM head (N = 151,936), mixtral-8x7b's LM head,
# whisper-small's tied head (N = 51,865, not a multiple of 8), mamba2-1.3b's
# head and zamba2-2.7b's shared GLU;
# then ragged ones: M = 100 and 300 against the 64/128-row tiles, N not a
# multiple of bn, K not a multiple of bk, and K or N not a multiple of 8
# (the wrapper's zero-padded copy for TMA).
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 2048, 2048), (12, 8192, 2048), (12, 2048, 92544),
                                   (12, 2048, 5632), (12, 5632, 2048), (12, 2048, 151936),
                                   (12, 4096, 32000), (12, 768, 51865), (12, 2048, 50280),
                                   (12, 2560, 10240), (12, 10240, 2560),
                                   (13, 100, 77), (300, 200, 180), (1, 8, 1),
                                   (100, 320, 1000), (100, 1000, 515), (64, 96, 72)])
def test_cuda_gemms_match_plain_and_each_other(cuda, shape):
    m, k, n = shape
    a, b = _operands(cuda, m, k, n)
    G.reset_launches()
    for stages, fn, plain in ((4, G.gemm_cuda, G.gemm_plain), (1, G.gemm_cuda_lean, G.gemm_lean_plain)):
        cfg = G.resolve_block_config(m, k, n, torch.bfloat16, stages=stages)
        got = fn(a, b, cfg)
        torch.testing.assert_close(got.float(), plain(a, b, cfg).float(), **BF16)
        f32 = fn(a, b, cfg, out_dtype=torch.float32)
        torch.testing.assert_close(f32, plain(a, b, cfg, out_dtype=torch.float32), **FP32)
        if stages == 4:  # the pipelined kernel's blocks fit both rings
            assert torch.equal(G.gemm_cuda_lean(a, b, cfg), got)  # bitwise at equal blocks
    torch.cuda.synchronize()
    assert G.LAUNCHES == {"gemm_cuda": 2, "gemm_cuda_lean": 3}


@pytest.mark.cuda
def test_cuda_gemm_tied_head_reads_a_transposed_embedding(cuda):
    """whisper-small's head: ``x · embed^T`` with the (51,865, 768)
    embedding's transposed view as B, whose N is not a multiple of 8 (the
    wrapper's zero-padded copy), at the decode's and the forward's M."""

    gen = torch.Generator(device=cuda).manual_seed(5)
    embed = (torch.randn((51865, 768), generator=gen, device=cuda) * 0.02).bfloat16()
    for m in (12, 896):
        a = torch.randn((m, 768), generator=gen, device=cuda).bfloat16()
        for stages, fn, plain in ((4, G.gemm_cuda, G.gemm_plain), (1, G.gemm_cuda_lean, G.gemm_lean_plain)):
            cfg = G.resolve_block_config(m, 768, 51865, torch.bfloat16, stages=stages)
            got = fn(a, embed.T, cfg)
            assert got.shape == (m, 51865)
            torch.testing.assert_close(got.float(), plain(a, embed.T.contiguous(), cfg).float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["big", "little"])
def test_qkv_projection_with_bias_matches_gemm_ref(cuda, cls):
    """qwen2-moe-a2.7b's q/k/v projection at the engine's 12 rows under each
    class's tree: the class's kernel plus the fp32 bias against ``gemm_ref``."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.kernels import ops

    a, w = _operands(cuda, 12, 2048, 2048, seed=3)
    bias = torch.randn((2048,), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    G.reset_launches()
    with AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context(cls):
        got = ops.linear(a, w, bias)
    want = (R.gemm_ref(a, w).float() + bias).bfloat16()
    torch.cuda.synchronize()
    assert G.LAUNCHES["gemm_cuda" if cls == "big" else "gemm_cuda_lean"] == 1
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("bm,bn", [(bm, bn) for bm in BM_TILES for bn in BN_TILES])
def test_cuda_gemm_every_tile_family(cuda, bm, bn, bk):
    """Every compiled (bm, bn) on a ragged problem: the plain version's
    result, lean == pipelined bitwise, in bf16 and in fp32."""

    a, b = _operands(cuda, 200, 300, 264, seed=1)
    cfg = BlockConfig(bm, bk, bn)
    for out_dtype, tol in ((torch.bfloat16, BF16), (torch.float32, FP32)):
        got = G.gemm_cuda(a, b, cfg, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        torch.testing.assert_close(got.float(), G.gemm_plain(a, b, cfg, out_dtype=out_dtype).float(), **tol)
        assert torch.equal(G.gemm_cuda_lean(a, b, cfg, out_dtype=out_dtype), got)


@pytest.mark.cuda
def test_cuda_gemm_reads_a_known_product(cuda):
    """A = I against a B of small integers: exact in bf16 and fp32, so any
    misread of B's MN-major layout shows as a wrong element."""

    a = torch.eye(128, 192, device=cuda).bfloat16()
    b = (torch.arange(192 * 264, device=cuda) % 97).reshape(192, 264).float().bfloat16()
    for bm in BM_TILES:
        for bn in BN_TILES:
            got = G.gemm_cuda(a, b, BlockConfig(bm, 64, bn), out_dtype=torch.float32)
            assert torch.equal(got, b[:128].float()), (bm, bn)


@pytest.mark.cuda
def test_cuda_gemm_rejects_what_it_cannot_run(cuda):
    a, b = _operands(cuda, 64, 64, 64)
    with pytest.raises(ValueError, match="compiled tile"):
        G.gemm_cuda(a, b, BlockConfig(bm=64, bk=32, bn=32))   # bk not a swizzle row
    with pytest.raises(ValueError, match="compiled tile"):
        G.gemm_cuda(a, b, BlockConfig(bm=64, bk=64, bn=48))
    with pytest.raises(TypeError, match="bf16"):
        G.gemm_cuda(a.float(), b.float(), BlockConfig(64, 64, 32))
    with pytest.raises(ValueError, match="CUDA device"):
        G.gemm_cuda(a, b.cpu(), BlockConfig(64, 64, 32))
    # A panel only the one-stage ring holds: the pipelined kernel refuses it
    # before launching, and a launch after that still succeeds.
    a, b = _operands(cuda, 128, 2048, 4096)
    lean_only = BlockConfig(bm=128, bk=256, bn=256)
    with pytest.raises(ValueError, match="shared memory"):
        G.gemm_cuda(a, b, lean_only)
    got = G.gemm_cuda_lean(a, b, lean_only)
    torch.testing.assert_close(got.float(), G.gemm_lean_plain(a, b, lean_only).float(), **BF16)


# (B, Hq, Hkv, Dh, ps, W, rows): internlm2-1.8b's heads (16 / 8 of 128)
# on one-page slots, the engine's pages, and a 4,096-token cache with
# random rows; GQA groups of 1, 2, 3 and 5 (deepseek-7b, internlm2-1.8b,
# minitron-4b, qwen2.5-32b) at head dims 64 and 128 (and 256) and pages of
# 8, 16 and 64, with the "edge" rows; full rows at 32,768 tokens;
# qwen2-moe-a2.7b's group of 1 (16 / 16 heads, 15 of the 16 rows of the
# kernel's tile padding) at its engine slot and at 4,096 tokens; and
# mixtral-8x7b's group of 4 on a 4,096-token ring at position 6,000 ("ring":
# past the window every slot is visible).
PAGED_CASES = [
    (12, 16, 8, 128, 24, 1, "random"),
    (12, 16, 8, 128, 16, 4, "random"),
    (12, 16, 8, 128, 64, 64, "random"),
    (8, 8, 8, 128, 8, 512, "edges"),
    (8, 16, 8, 64, 16, 256, "edges"),
    (8, 24, 8, 128, 16, 256, "edges"),
    (8, 40, 8, 128, 64, 64, "edges"),
    (8, 10, 2, 64, 8, 512, "edges"),
    (8, 6, 2, 128, 64, 16, "edges"),
    (8, 16, 8, 256, 16, 64, "edges"),
    (12, 16, 8, 128, 64, 512, "full"),
    (2, 6, 2, 128, 64, 512, "full"),
    (12, 16, 16, 128, 8, 3, "random"),
    (12, 16, 16, 128, 64, 64, "full"),
    (12, 32, 8, 128, 64, 64, "ring"),
]


def _paged_operands(cuda, case):
    """Random operands of one case, the rows set by its kind; "edges" rows:
    dead (every table entry unallocated), aged past the cache, ending inside
    the first run, on the last position of a run, one position into the
    next run, on a page boundary inside a run, full, and random."""

    b, hq, hkv, d, ps, w, rows = case
    gen = torch.Generator(device=cuda).manual_seed(ps * w + hq + d)
    n_pages = b * w + 3
    q = torch.randn((b, hq, d), generator=gen, device=cuda).bfloat16()
    pk = torch.randn((n_pages, ps, hkv, d), generator=gen, device=cuda).bfloat16()
    pv = torch.randn((n_pages, ps, hkv, d), generator=gen, device=cuda).bfloat16()
    table = torch.randperm(n_pages, generator=gen, device=cuda)[:b * w].reshape(b, w).int()
    s_cache = w * ps
    if rows in ("full", "ring"):
        pos = torch.full((b,), s_cache - 1 if rows == "full" else 6000, dtype=torch.int32,
                         device=cuda)
    else:
        pos = torch.randint(0, s_cache, (b,), generator=gen, device=cuda, dtype=torch.int32)
        table[0] = SENTINEL            # a dead row
        pos[1] = s_cache + 9           # a row aged past its cache
    if rows == "edges":
        run = PA.split_plan(b, hkv, w, ps, PA.sm_count(cuda)).pages * ps
        assert run < s_cache, "an edge case needs more than one run"
        pos[2:7] = torch.tensor([run // 2, run - 1, run, 2 * ps - 1 if 2 * ps < run else ps - 1,
                                 s_cache - 1], dtype=torch.int32)
    return q, pk, pv, table, pos


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_paged_attention_matches_plain(cuda, case):
    q, pk, pv, table, pos = _paged_operands(cuda, case)
    PA.reset_launches()
    got = PA.paged_attention_cuda(q, pk, pv, table, pos)
    torch.cuda.synchronize()
    assert PA.LAUNCHES["paged_attention_cuda"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = PA.paged_attention_torch(q, pk, pv, table, pos)
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    assert row_rel_err(got, want) <= FLASH_ROW_TOL
    # The same call again gives the same bits (no atomics in the combine).
    assert torch.equal(PA.paged_attention_cuda(q, pk, pv, table, pos), got)
    plan = PA.split_plan(q.shape[0], pk.shape[2], table.shape[1], pk.shape[1], PA.sm_count(cuda))
    twin = PA.paged_attention_split_torch(q, pk, pv, table, pos, plan)
    torch.testing.assert_close(got.float(), twin.float(), **BF16)
    assert row_rel_err(got, twin) <= FLASH_ROW_TOL


def test_paged_row_check_separates_a_dropped_split():
    """On the CPU, at a 4,096-token cache split in three runs (the plan of
    serving's 12 rows and 8 KV heads on 132 SMs): the split walk stays
    within ``FLASH_ROW_TOL`` of the gather route, while the walk with one
    run dropped lies far outside it."""

    gen = torch.Generator().manual_seed(5)
    b, hkv, g, d, ps, w = 2, 2, 2, 64, 16, 256
    plan = PA.split_plan(12, 8, w, ps, 132)
    assert plan.n_split == 3
    q = torch.randn((b, hkv * g, d), generator=gen).bfloat16()
    pk, pv = (torch.randn((b * w, ps, hkv, d), generator=gen).bfloat16() for _ in range(2))
    table = torch.arange(b * w, dtype=torch.int32).reshape(b, w)
    pos = torch.full((b,), w * ps - 1, dtype=torch.int32)
    want = PA.paged_attention_torch(q, pk, pv, table, pos)
    assert row_rel_err(PA.paged_attention_split_torch(q, pk, pv, table, pos, plan), want) <= FLASH_ROW_TOL / 2

    m, l, acc = PA.split_partials(q, pk, pv, table, pos, plan)
    m[:, 1], l[:, 1], acc[:, 1] = PA.NEG_INF, 0.0, 0.0
    dropped = PA.combine_splits(m, l, acc).reshape(q.shape).bfloat16()
    assert row_rel_err(dropped, want) > 5 * FLASH_ROW_TOL


@pytest.mark.cuda
def test_cuda_paged_attention_rejects_what_it_cannot_run(cuda):
    q = torch.zeros((2, 4, 16), dtype=torch.bfloat16, device=cuda)
    pages = torch.zeros((3, 4, 2, 16), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        PA.paged_attention_cuda(q.float(), pages.float(), pages.float(), table, pos)
    with pytest.raises(TypeError, match="int32"):
        PA.paged_attention_cuda(q, pages, pages, table.long(), pos)
    with pytest.raises(ValueError, match="head dim"):
        PA.paged_attention_cuda(q[..., :12], pages[..., :12], pages[..., :12], table, pos)
    with pytest.raises(ValueError, match="group"):
        PA.paged_attention_cuda(torch.zeros((2, 18, 16), dtype=torch.bfloat16, device=cuda),
                                pages, pages, table, pos)
    with pytest.raises(ValueError, match="CUDA device"):
        PA.paged_attention_cuda(q, pages.cpu(), pages.cpu(), table, pos)


# (B, Sq, Sk, Hq, Hkv, D, causal, window): the forward's layer shape at full
# width of minitron-4b, a ragged suffix, a window, a non-causal call, small
# heads, GQA groups of 1, 2 and 3, and the new families' shapes (head dim
# 80; non-causal over 1,500 keys, not a multiple of the 64-key block).
FLASH_CASES = [
    (2, 2048, 2048, 24, 8, 128, True, None),
    (2, 100, 300, 24, 8, 128, True, None),
    (1, 1000, 1000, 24, 8, 128, True, 256),
    (2, 300, 300, 24, 8, 128, False, None),
    (3, 77, 77, 4, 2, 16, True, None),
    (1, 130, 200, 6, 2, 64, False, 50),
    (1, 64, 64, 2, 2, 256, True, None),
    (2, 200, 200, 8, 8, 128, True, None),      # GQA group 1
    (1, 300, 300, 16, 8, 128, True, 100),      # GQA group 2, window
    (1, 200, 260, 6, 2, 72, False, None),      # GQA group 3, D padded to 128
    (2, 2048, 2048, 32, 32, 80, True, None),   # zamba2-2.7b's shared block: D 80
    (2, 1500, 1500, 12, 12, 64, False, None),  # whisper-small's encoder: 1,500 keys
    (2, 448, 1500, 12, 12, 64, False, None),   # its cross-attention in the forward
    (12, 1, 1500, 12, 12, 64, False, None),    # and in a decode step
    (6, 512, 512, 8, 4, 128, True, None),      # internlm2-1.8b's prefill a rank at (data=2, model=2)
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_attention_matches_plain(cuda, case):
    b, sq, sk, hq, hkv, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((b, sq, hq, d), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, hkv, d), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, hkv, d), generator=gen, device=cuda).bfloat16()
    FA.reset_launches()
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_cuda"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = FA.flash_attention_torch(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    assert row_rel_err(got, want) <= FLASH_ROW_TOL


def test_flash_row_check_separates_a_dropped_key_block(monkeypatch):
    """On the CPU, at a causal shape with 1024 keys: an attention that
    rounds p elsewhere (``attention_ref``, fp32 p) stays within
    ``FLASH_ROW_TOL`` of the plain walk, while the plain walk with one key
    block dropped for its last four q-blocks lies far outside it."""

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 1024, 2, 64), generator=gen).bfloat16() for _ in range(3))
    want = FA.flash_attention_torch(q, k, v, causal=True)
    assert row_rel_err(R.attention_ref(q, k, v, causal=True), want) <= FLASH_ROW_TOL / 2

    sound = FA.key_blocks

    def drop_one(q0, sq, sk, causal, window):
        return [kb for kb in sound(q0, sq, sk, causal, window) if not (q0 >= 768 and kb == 5)]

    monkeypatch.setattr(FA, "key_blocks", drop_one)
    assert row_rel_err(FA.flash_attention_torch(q, k, v, causal=True), want) > 5 * FLASH_ROW_TOL


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_cannot_run(cuda):
    q = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        FA.flash_attention_cuda(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="suffix"):
        FA.flash_attention_cuda(q, q[:, :4], q[:, :4], causal=True)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_cuda(q[..., :12], q[..., :12], q[..., :12])
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_cuda(q, q.cpu(), q.cpu())
    assert X.resolve_flash_attn_backend("auto", q.device) == "flash_attn_cuda"


# The backward's shapes: internlm2-1.8b's training layer (4 x 2,048, 16 / 8
# heads of 128), zamba2-2.7b's shared block (head dim 80), whisper-small's
# encoder and its non-causal 448 x 1,500 cross-attention, a windowed GQA
# group of 4, and a ragged reduced config's (head dim 16).
FLASH_BWD_CASES = [
    (4, 2048, 2048, 16, 8, 128, True, None),
    (1, 2048, 2048, 32, 32, 80, True, None),
    (2, 1500, 1500, 12, 12, 64, False, None),
    (2, 448, 1500, 12, 12, 64, False, None),
    (1, 1000, 1000, 16, 4, 128, True, 256),
    (3, 77, 77, 4, 2, 16, True, None),
]


def _flash_bwd_operands(cuda, case, seed=0):
    b, sq, sk, hq, hkv, d, _, _ = case
    gen = torch.Generator(device=cuda).manual_seed(seed + sq + sk)
    shapes = ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))
    return [torch.randn(s, generator=gen, device=cuda).bfloat16() for s in shapes]


def _flash_grads(q, k, v, dout, **kw):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_attention_cuda(*leaves, **kw)
    out.backward(dout)
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_flash_backward_matches_plain(cuda, case):
    """The training forward (its output bitwise the inference kernel's, its
    log-sum-exp the plain version's) and the two backward kernels' dQ, dK,
    dV against ``flash_attention_bwd_torch``, one launch each."""

    *_, causal, window = case
    kw = dict(causal=causal, window=window)
    q, k, v, dout = _flash_bwd_operands(cuda, case)
    FA.reset_launches()
    out, grads = _flash_grads(q, k, v, dout, **kw)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_attention_cuda": 0, "flash_attention_fwd_lse": 1,
                           "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkdv": 1}
    assert torch.equal(out, FA.flash_attention_cuda(q, k, v, **kw))
    o, lse = FA.flash_attention_torch(q, k, v, with_lse=True, **kw)
    _, _, _, shape = FA._checked(q, k, v, causal, window, FA.BWD_MAX_D, "test")
    _, lse_kernel = FA._forward_lse(q, k, v, shape, causal, window, 1.0 / math.sqrt(q.shape[-1]))
    torch.testing.assert_close(lse_kernel[..., :q.shape[1]], lse, rtol=1e-4, atol=1e-4)
    want = FA.flash_attention_bwd_torch(q, k, v, o, dout, lse, **kw)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        assert bool(torch.isfinite(got.float()).all()), name
        err = grad_row_err(got, ref)
        assert err <= FLASH_ROW_TOL, (name, err)


def test_flash_backward_row_check_separates_a_dropped_key_block(monkeypatch):
    """On the CPU, at a causal shape with 1,024 keys: autograd through
    ``chunked_attention``, which multiplies ``dS`` in fp32 where the kernels
    and the plain backward round it to bf16, stays within ``FLASH_ROW_TOL``
    of the plain backward (1.5e-2), while the plain backward
    with one key block dropped, from dQ's walk or from dK/dV's, lies far
    outside it."""

    gen = torch.Generator().manual_seed(3)
    q, k, v, dout = (torch.randn((1, 1024, 2, 64), generator=gen).bfloat16() for _ in range(4))
    o, lse = FA.flash_attention_torch(q, k, v, causal=True, with_lse=True)
    want = FA.flash_attention_bwd_torch(q, k, v, o, dout, lse, causal=True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    L.chunked_attention(*leaves, causal=True).backward(dout)
    assert max(grad_row_err(t.grad, w) for t, w in zip(leaves, want)) <= FLASH_ROW_TOL

    keys, queries = FA.key_blocks, FA.query_blocks
    monkeypatch.setattr(FA, "key_blocks", lambda q0, sq, sk, c, w: [
        kb for kb in keys(q0, sq, sk, c, w) if not (q0 >= 768 and kb == 5)])
    got = FA.flash_attention_bwd_torch(q, k, v, o, dout, lse, causal=True)
    assert grad_row_err(got[0], want[0]) > 5 * FLASH_ROW_TOL
    monkeypatch.setattr(FA, "key_blocks", keys)
    monkeypatch.setattr(FA, "query_blocks", lambda kb, sq, sk, c, w: [
        qb for qb in queries(kb, sq, sk, c, w) if not (kb == 5 and qb >= 12)])
    got = FA.flash_attention_bwd_torch(q, k, v, o, dout, lse, causal=True)
    assert min(grad_row_err(g, w) for g, w in zip(got[1:], want[1:])) > 5 * FLASH_ROW_TOL


@pytest.mark.cuda
def test_cuda_flash_backward_is_bitwise_deterministic(cuda):
    """No sum crosses blocks: two backward calls on the same inputs (a GQA
    group of 2, causal, internlm2's width) give the same bits."""

    q, k, v, dout = _flash_bwd_operands(cuda, (2, 1024, 1024, 16, 8, 128, True, None), seed=5)
    first = _flash_grads(q, k, v, dout)[1]
    second = _flash_grads(q, k, v, dout)[1]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_backward_rejects_what_it_cannot_run(cuda):
    q = torch.zeros((1, 64, 2, 256), dtype=torch.bfloat16, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="head dim 256"):
        FA.flash_attention_cuda(q, q, q)
    with torch.no_grad():  # the inference kernel takes it
        assert FA.flash_attention_cuda(q, q, q).shape == q.shape
    with pytest.raises(TypeError, match="bf16"):
        FA.flash_attention_cuda(q[..., :64].float(), q[..., :64].float(), q[..., :64].float())


@pytest.mark.cuda
def test_full_width_layer_attention_launches_the_kernel_once(cuda):
    """One layer of minitron-4b at full width (24 query heads over 8 KV
    heads of 128) on a 256-token sequence: its attention is one launch."""

    cfg = get_config("minitron-4b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    acfg = T.attn_config(cfg)
    p = L.init_attention(gen, acfg, device=cuda)
    x = (torch.randn((1, 256, cfg.d_model), generator=gen, device=cuda)).bfloat16()
    FA.reset_launches()
    with torch.no_grad():
        out, (k, _) = L.apply_attention(p, x, acfg)
        plain, _ = L.apply_attention(p, x, acfg, backend="flash_attn_torch")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_cuda"] == 1
    assert out.shape == x.shape and tuple(k.shape) == (1, 256, 8, 128)
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), plain.float(), **BF16)


# ---------------------------------------------------------------------------
# The measured loop: the tuner's device clock, its candidates, the probe
# ---------------------------------------------------------------------------

# A decode shape of full-width internlm2-1.8b (M = 12 rows of the slot
# table) and the forward's shapes of minitron-4b (M = 2 x 2048).
DECODE_SHAPES = [(12, 2048, 2048), (12, 2048, 1024), (12, 2048, 8192), (12, 8192, 2048),
                 (12, 2048, 92544)]
FORWARD_SHAPES = [(4096, 3072, 3072), (4096, 3072, 1024), (4096, 3072, 9216),
                  (4096, 9216, 3072), (4096, 3072, 256000)]
# The device clock against the profiler's kernel time, either way: the
# events also hold the card's gaps between back-to-back launches (about a
# microsecond against a kernel of several).
DEVICE_CLOCK_FACTOR = 1.5


@pytest.mark.cuda
def test_wallclock_reads_device_time_not_the_hosts(cuda):
    """``wallclock_time`` at a decode shape agrees with ``torch.profiler``'s
    device time for the same calls, and reads below the host's time a call
    (the enqueue rate that back-to-back host timing would read)."""

    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.tuning import measure as M

    m, k, n = DECODE_SHAPES[0]
    cfg = G.resolve_block_config(m, k, n, torch.bfloat16)
    clock = M.wallclock_time(m, k, n, cfg, device=cuda)
    # The same calls: B cycled over the copies wallclock_time uses.
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    bs = [torch.randn((k, n), generator=gen, device=cuda).bfloat16()
          for _ in range(min(64, math.ceil(128e6 / (k * n * 2))))]
    for b in bs:
        G.gemm_cuda(a, b, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in bs:
            G.gemm_cuda(a, b, cfg)
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type != DeviceType.CPU and "gemm" in e.name]
    assert len(evs) == len(bs)
    device = sum(e.time_range.elapsed_us() for e in evs) / 1e6 / len(evs)
    t0 = time.perf_counter()
    for b in bs * 4:
        G.gemm_cuda(a, b, cfg)
    host = (time.perf_counter() - t0) / (4 * len(bs))
    torch.cuda.synchronize()
    print(f"wallclock {clock * 1e6:.2f} us, profiler {device * 1e6:.2f} us, host {host * 1e6:.2f} us a call")
    assert device / DEVICE_CLOCK_FACTOR <= clock <= DEVICE_CLOCK_FACTOR * device
    assert clock < host


@pytest.mark.cuda
@pytest.mark.parametrize("spec_name", ["h100", "h100-little"])
@pytest.mark.parametrize("shape", DECODE_SHAPES + FORWARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_tuning_candidate_launches_and_matches_plain(cuda, spec_name, shape):
    """Every (block, variant) the tuner may time runs on its kernel and
    matches the plain version: a candidate the kernel rejects would be a
    fault of the candidate generator."""

    from repro_torch.tuning import candidates as CAND

    m, k, n = shape
    a, b = _operands(cuda, m, k, n, seed=3)
    refs = {}
    cands = CAND.enumerate_kernel_candidates(m, k, n, spec=CAND.get_spec(spec_name))
    assert cands
    for cand in cands:
        got = G.GEMM_KERNELS[cand.backend](a, b, cand.cfg)
        if cand.cfg.bk not in refs:  # the plain version depends on bk alone
            refs[cand.cfg.bk] = G.gemm_plain(a, b, cand.cfg).float()
        torch.testing.assert_close(got.float(), refs[cand.cfg.bk], **BF16)
        del got


@pytest.mark.cuda
def test_probe_times_each_class_kernel_on_the_card(cuda):
    """``StepTimeProbe.refresh()`` launches ``gemm_cuda`` under the big
    class and ``gemm_cuda_lean`` under the little one, on bf16 operands."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.observability.probe import StepTimeProbe

    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    probe = StepTimeProbe(asym, probe_shape=(128, 2048, 2048), always=True, device=cuda)
    assert asym.class_backends((128, 2048, 2048)) == {"big": "cuda", "little": "cuda_lean"}
    G.reset_launches()
    rows = probe.refresh()
    torch.cuda.synchronize()
    assert G.LAUNCHES["gemm_cuda"] > 0 and G.LAUNCHES["gemm_cuda_lean"] > 0
    assert probe._operands[0].dtype == probe._operands[1].dtype == torch.bfloat16
    assert len(rows) == 2 and all(r > 0 for r in rows)


# ---------------------------------------------------------------------------
# Training: the GEMM autograd Function's backward, one step on the card
# ---------------------------------------------------------------------------


def _function_grads(ctx, a, b, dc, fn=None):
    from repro_torch.kernels import ops

    a, b = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    with ctx:
        out = (fn or ops.gemm)(a, b)
        out.backward(dc)
    return out.detach(), a.grad, b.grad


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 256, 384), (1024, 2048, 1024), (200, 136, 328)])
def test_gemm_function_backward_matches_plain(cuda, shape):
    """The Function's output, dA and dB through ``gemm_cuda`` and
    ``gemm_cuda_lean`` against the same Function on their plain versions
    (bf16 tolerance), and lean == pipelined bitwise at one hand-built
    block for every product."""

    import dataclasses

    from repro_torch.core import control_tree as CT
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes

    m, k, n = shape
    a, b = _operands(cuda, m, k, n, seed=4)
    dc = _operands(cuda, m, n, 8, seed=5)[0]  # unit scale: dA, dB are O(1) and more
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    for cls, kernel in (("big", "gemm_cuda"), ("little", "gemm_cuda_lean")):
        ctx = asym.execution_context(cls)
        plain = X.context_for_tree(dataclasses.replace(ctx.tree, backend=X.plain_twin(ctx.backend())))
        G.reset_launches()
        got = _function_grads(ctx, a, b, dc)
        torch.cuda.synchronize()
        assert G.LAUNCHES[kernel] == 3 and sum(G.LAUNCHES.values()) == 3
        want = _function_grads(plain, a, b, dc)
        for x, y in zip(got, want):
            assert x.dtype == torch.bfloat16
            torch.testing.assert_close(x.float(), y.float(), **BF16)
            assert row_rel_err(x, y) <= GEMM_ROW_TOL
        # A dA that skipped its reduction's first K-tile fails the row check.
        blk = ctx.block_config(m, n, k, "bfloat16", 2)
        dropped = dc.clone()
        dropped[:, :blk.bk] = 0
        fn = G.gemm_cuda if kernel == "gemm_cuda" else G.gemm_cuda_lean
        assert row_rel_err(fn(dropped, b.t().contiguous(), blk), want[1]) > 2 * GEMM_ROW_TOL
    blk = BlockConfig(bm=64, bk=64, bn=64)
    pair = [_function_grads(X.context_for_tree(CT.ControlTree(device_class="hand", block=blk,
                                                              backend=be)), a, b, dc)
            for be in ("cuda", "cuda_lean")]
    for x, y in zip(*pair):
        assert torch.equal(x, y)


def test_gemm_row_check_separates_a_dropped_k_tile():
    """On the CPU, at the head's dA reduction (N = 92,544) with a
    unit-scale cotangent: the Function's dA through the plain version
    stays within ``GEMM_ROW_TOL`` of ``torch.matmul`` autograd, while the
    plain product with one K-tile of 64 dropped lies outside twice it."""

    from repro_torch.core import control_tree as CT

    gen = torch.Generator().manual_seed(6)
    m, k, n = 64, 128, 92544
    a = torch.randn((m, k), generator=gen).bfloat16()
    b = (torch.randn((k, n), generator=gen) / math.sqrt(k)).bfloat16()
    dc = torch.randn((m, n), generator=gen).bfloat16()
    blk = BlockConfig(bm=64, bk=64, bn=64)
    tree = CT.ControlTree(device_class="hand", block=blk, backend=X.plain_twin("cuda"))
    da = _function_grads(X.context_for_tree(tree), a, b, dc)[1]
    want = _function_grads(contextlib.nullcontext(), a, b, dc, torch.matmul)[1]
    assert row_rel_err(da, want) <= GEMM_ROW_TOL / 2
    dropped = dc.clone()
    dropped[:, n // 2:n // 2 + blk.bk] = 0
    assert row_rel_err(G.gemm_plain(dropped, b.t().contiguous(), blk), da) > 2 * GEMM_ROW_TOL


@pytest.mark.cuda
def test_one_training_step_runs_every_gemm_on_the_kernel(cuda, tmp_path):
    """One step of the reduced internlm2 on the card: (7L+1) forward GEMMs,
    7L recomputed and 2(7L+1) backward, all ``gemm_cuda``; attention on the
    training flash kernels (the log-sum-exp forward twice a layer, in the
    forward and the recompute; each backward kernel once), no inference
    flash launch and no ``chunked_attention`` call."""

    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("internlm2-1.8b").reduced()
    trainer = Trainer(cfg, tcfg=TrainerConfig(steps=1, global_batch=4, seq_len=64,
                                              ckpt_dir=str(tmp_path)),
                      exec_ctx=X.default_context(), device=cuda)
    assert trainer.exec_ctx.backend() == "cuda"
    batch, _ = trainer.next_batch(0)
    G.reset_launches()
    FA.reset_launches()
    chunked = L.CUDA_CALLS["chunked_attention"]
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    n = 7 * cfg.n_layers + 1
    assert G.LAUNCHES["gemm_cuda"] == n + 7 * cfg.n_layers + 2 * n
    assert G.LAUNCHES["gemm_cuda_lean"] == 0
    assert FA.LAUNCHES == {"flash_attention_cuda": 0, "flash_attention_fwd_lse": 2 * cfg.n_layers,
                           "flash_attention_bwd_dq": cfg.n_layers,
                           "flash_attention_bwd_dkdv": cfg.n_layers}
    assert L.CUDA_CALLS["chunked_attention"] == chunked
    assert math.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0


@pytest.mark.cuda
def test_full_width_training_step_runs_attention_on_the_flash_kernels(cuda, tmp_path):
    """One step of the full-width internlm2-1.8b (24 layers, 16 / 8 heads of
    128; 2 x 512 tokens): each backward kernel once a layer, the log-sum-exp
    forward twice (forward and recompute), no ``chunked_attention`` call on
    a CUDA tensor, a finite loss near ln V."""

    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("internlm2-1.8b")
    trainer = Trainer(cfg, tcfg=TrainerConfig(steps=1, global_batch=2, seq_len=512,
                                              ckpt_dir=str(tmp_path)),
                      exec_ctx=X.default_context(), device=cuda)
    batch, _ = trainer.next_batch(0)
    FA.reset_launches()
    chunked = L.CUDA_CALLS["chunked_attention"]
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_attention_cuda": 0, "flash_attention_fwd_lse": 48,
                           "flash_attention_bwd_dq": 24, "flash_attention_bwd_dkdv": 24}
    assert L.CUDA_CALLS["chunked_attention"] == chunked
    assert abs(float(metrics["loss"]) - math.log(cfg.vocab)) <= 0.5
    assert float(metrics["grad_norm"]) > 0


def _train_state(cfg, device):
    """Random fp32 masters from seed 0 (drawn on the CPU) and a batch."""

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model_zoo as Z
    from repro_torch.optim import adamw as O

    params = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    params = O.tree_map(lambda p: p.to(device).requires_grad_(True), params)
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(cfg.vocab, seed=0).batch(0, 4, 64).items()}
    return params, batch


@pytest.mark.cuda
def test_moe_training_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The reduced qwen2-moe's loss, aux loss and every gradient leaf on the
    card (``gemm_cuda``, the experts' ``bmm`` on cuBLAS) against the CPU
    (the plain versions) from the same masters and batch, under the CPU's
    routing forced on the card (a last-bit difference may flip a top-k
    choice): loss within 2e-3, aux within 1e-4 relative, each leaf within
    0.03 relative L2, as the CPU tests hold the port to the reference.
    Without remat, so ``route`` runs once a layer in order on both sides.
    Then one AdamW step each: ``grad_norm`` within 3%."""

    from repro_torch.models import model_zoo as Z
    from repro_torch.models import moe as M
    from repro_torch.optim import adamw as O

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    real_route, ids, calls = M.route, [], []

    def capture(p, x, mcfg):
        out = real_route(p, x, mcfg)
        ids.append(out[1])
        return out

    def forced(p, x, mcfg):
        _, _, probs = real_route(p, x, mcfg)
        idx = ids[len(calls) % len(ids)].to(x.device)
        calls.append(1)
        gate_w = probs.gather(-1, idx)
        return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), idx, probs

    loss_fn = Z.make_loss_fn(cfg, remat=False)
    res = {}
    for device, route in (("cpu", capture), ("cuda", forced)):
        monkeypatch.setattr(M, "route", route)
        params, batch = _train_state(cfg, device)
        with X.default_context():
            loss, metrics, grads = O.value_and_grad(loss_fn, params, batch)
            _, _, om = O.adamw_update(params, grads, O.init_opt_state(params), O.AdamWConfig())
        res[device] = (float(loss), float(metrics["aux"]), O.tree_map(lambda g: g.cpu(), grads),  # repro_torch: noqa=RPR001 -- the clipped gradients AdamW left in place are what is compared
                       float(om["grad_norm"]))
    assert len(calls) == cfg.n_layers
    (loss, aux, grads, gn), (closs, caux, cgrads, cgn) = res["cuda"], res["cpu"]
    assert abs(loss - closs) <= 2e-3 and aux == pytest.approx(caux, rel=1e-4) and aux > 0
    for g, cg in zip(O.tree_leaves(grads), O.tree_leaves(cgrads)):
        assert float((g - cg).norm() / cg.norm().clamp_min(1e-12)) <= 0.03
    assert gn == pytest.approx(cgn, rel=3e-2)


@pytest.mark.cuda
def test_mamba2_block_backward_on_the_card_matches_the_cpu(cuda):
    """A reduced Mamba2 block's output, input gradient and parameter
    gradients on the card against the CPU, in L2 relative to each row's
    norm within ``GEMM_ROW_TOL`` x 2 (both bf16; cuBLAS and the CPU sum the
    projections in other orders)."""

    from repro_torch.models import ssm as S

    cfg = get_config("mamba2-1.3b").reduced().ssm
    gen = torch.Generator().manual_seed(3)
    masters = {k: v[0] for k, v in S.init_mamba2(gen, cfg, 1, device="cpu", dtype=torch.float32).items()}
    x = torch.randn((2, 64, cfg.d_model), generator=gen).bfloat16()
    ct = torch.randn((2, 64, cfg.d_model), generator=gen).bfloat16()
    res = {}
    for device in ("cpu", "cuda"):
        p = {k: v.to(device).bfloat16().requires_grad_(True) for k, v in masters.items()}
        xx = x.to(device).detach().requires_grad_(True)
        y, state = S.apply_mamba2(p, xx, cfg)
        y.backward(ct.to(device))
        res[device] = [y.detach(), state, xx.grad] + [p[k].grad for k in sorted(p)]
    for got, want in zip(res["cuda"], res["cpu"]):
        got, want = got.cpu(), want
        assert bool(torch.isfinite(got.float()).all())
        assert row_rel_err(got if got.ndim > 1 else got[None], want if want.ndim > 1 else want[None]) \
            <= 2 * GEMM_ROW_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_step,attn", [
    ("qwen2-moe-a2.7b", 115, 4),  # 4 x (q, k, v, o, the shared GLU's 3) + the head = 29
    ("mamba2-1.3b", 3, 0),        # the head
    ("zamba2-2.7b", 59, 2),       # 2 groups' shared block (7) + the head = 15
    ("whisper-small", 211, 10),   # 2 encoder layers x 6 + 4 decoder layers x 10 + the head = 53
])
def test_training_step_launch_formula(cuda, arch, per_step, attn):
    """A training step at reduced depth launches 4n - 1 ``gemm_cuda`` (n
    the forward's GEMMs: the forward, its recompute less the head, two
    backward products each; the enc-dec's encoder is always recomputed,
    its decoder under remat), and for each of its ``attn`` attentions
    (whisper's: 2 encoder, 4 decoder and 4 cross) the log-sum-exp forward
    twice and each backward kernel once; no inference flash launch and no
    ``chunked_attention`` call: the formulas ``chip_smoke.py`` phases
    17-19 hold at full width."""

    from repro_torch.models import model_zoo as Z
    from repro_torch.optim import adamw as O

    cfg = get_config(arch).reduced()
    params, batch = _train_state(cfg, "cuda")
    if cfg.family == "encdec":
        gen = torch.Generator().manual_seed(1)
        batch["frames"] = torch.randn((4, cfg.enc_frames, cfg.d_model), generator=gen).bfloat16().cuda()
    G.reset_launches()
    FA.reset_launches()
    chunked = L.CUDA_CALLS["chunked_attention"]
    with X.default_context():
        loss, _, grads = O.value_and_grad(Z.make_loss_fn(cfg), params, batch)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gemm_cuda"] == per_step and G.LAUNCHES["gemm_cuda_lean"] == 0
    assert FA.LAUNCHES == {"flash_attention_cuda": 0, "flash_attention_fwd_lse": 2 * attn,
                           "flash_attention_bwd_dq": attn, "flash_attention_bwd_dkdv": attn}
    assert L.CUDA_CALLS["chunked_attention"] == chunked
    assert math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all()) for g in O.tree_leaves(grads))


# ---------------------------------------------------------------------------
# The class-sharded step: pods as streams on the one card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_mixed_gemm_step_on_two_streams_equals_each_pod_alone(cuda):
    """The big pod's rows on ``gemm_cuda`` and the little pod's on
    ``gemm_cuda_lean``, each on its own stream: bitwise each pod's rows
    run alone on the default stream under its own class."""

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.distributed.sharding import PodSplit
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    am = AsymmetricMesh(biglittle_classes(chips_per_pod=1), tree_shape=(1024, 1024, 1024))
    assert am.class_backends() == {"big": "cuda", "little": "cuda_lean"}
    mesh = make_host_mesh(pod=2, device=cuda)
    step = am.class_sharded(lambda x, w: ops.gemm(x, w), mesh=mesh,
                            in_specs=(PodSplit(0), None), out_specs=PodSplit(0))
    streams = mesh.pod_streams()
    assert len({s.stream_id for s in streams} | {torch.cuda.current_stream().stream_id}) == 3
    a, b = _operands(cuda, 2 * 384, 2048, 2048, seed=3)
    G.reset_launches()
    out = step(a, b)
    assert G.LAUNCHES == {"gemm_cuda": 1, "gemm_cuda_lean": 1}
    for pod, cls in enumerate(("big", "little")):
        with am.execution_context(cls):
            alone = ops.gemm(a[pod * 384:(pod + 1) * 384], b)
        torch.cuda.synchronize()
        assert torch.equal(out[pod * 384:(pod + 1) * 384], alone), cls


@pytest.mark.cuda
def test_paged_attention_on_a_side_stream_equals_the_default_stream(cuda):
    """The paged kernel (and its split workspace) on a non-default stream:
    bitwise its output on the default stream."""

    case = (12, 16, 8, 128, 64, 64, "full")
    q, pk, pv, table, pos = _paged_operands(cuda, case)
    want = PA.paged_attention_cuda(q, pk, pv, table, pos)
    assert PA.split_plan(12, 8, 64, 64, PA.sm_count(cuda)).n_split > 1  # the workspace is used
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = PA.paged_attention_cuda(q, pk, pv, table, pos)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_sharded_step_on_ranks_sharing_the_card(cuda, tmp_path):
    """Four ranks on the card as a (data=2, model=2) mesh over ``gloo``:
    the collectives on CUDA tensors (staged through host memory) give
    their definitions, every product of a sharded training step runs on
    ``gemm_cuda`` (4n - 1 launches a rank), and the losses follow the
    one-process trainer's on the card within 1e-3."""

    import spmd_workers as W
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.optim import adamw as O
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tcfg, opt = dict(steps=2, global_batch=4, seq_len=16), dict(lr=1e-3, total_steps=2, warmup_steps=2)
    cfg = get_config(W.ARCH).reduced()
    # The one-process run first: it builds the kernel the ranks then load.
    one = Trainer(cfg, device=cuda, opt_cfg=O.AdamWConfig(**opt),
                  tcfg=TrainerConfig(ckpt_dir=str(tmp_path / "one"), ckpt_every=100, **tcfg))
    want = []
    for step in range(tcfg["steps"]):
        batch, _ = one.next_batch(step)
        want.append(float(one.train_step(batch)["loss"]))
    runs = spawn_ranks(W.card_run, 4, {"mesh": (2, 2, 0), "tcfg": tcfg, "opt": opt,
                                       "ckpt_dir": str(tmp_path / "r")}, device="cuda", timeout=300)
    n = 7 * cfg.n_layers + 1
    for rank, run in enumerate(runs):
        assert run["transport"] == "gloo" and run["device"] == "cuda:0"
        for got, loss in zip(run["steps"], want):
            assert got["launches"]["gemm_cuda"] == 4 * n - 1
            assert got["loss"] == pytest.approx(loss, rel=1e-3)
        model_peer = rank ^ 1  # the other rank of this rank's model group
        assert run["gathered"][:, :3].eq(min(rank, model_peer) + 1).all()
        assert run["gathered"][:, 3:].eq(max(rank, model_peer) + 1).all()
        assert run["reduced"].eq(10.0).all()
        data_index = rank // 2
        assert torch.equal(run["scattered"], 2 * torch.arange(8.0).reshape(4, 2)[2 * data_index:2 * data_index + 2])


# ---------------------------------------------------------------------------
# The program's spans on the card: device time, the profiler's clock
# ---------------------------------------------------------------------------


def _mixed_trainer(tmp_path, device):
    """The benchmark's mixed training cell's model (internlm2-1.8b at full
    width, cut to 2 layers) through the class-sharded step on two
    streams."""

    import dataclasses

    from repro_torch.launch import train as LT

    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=2)
    args = LT.build_parser().parse_args([
        "--arch", "internlm2-1.8b", "--device", "cuda", "--global-batch", "4", "--seq", "512",
        "--heterogeneous", "--class-sharded", "on", "--ckpt-dir", str(tmp_path)])
    trainer = LT.make_trainer(args, cfg=cfg)
    assert trainer.class_sharded_step is not None
    return trainer, trainer.next_batch(0)[0]


def _profiled_on_card(fn):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.observability import trace as TRC

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof, TRC.profiled_spans()


def _span_readers(names, units):
    """Each of the benchmark's span readers ``names`` on this session."""

    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import counts
    from portbench import run as RUN

    run = {"trace": {"units": units}, "peaks": counts.peaks()}
    return {n: RUN.load_reader(n)(run) for n in names}


@pytest.mark.cuda
def test_spans_read_device_time_and_reach_the_profiler_as_cpu_ranges(cuda, tmp_path):
    """A mixed training step and a prefill, each under a profiler: every
    span has its device time, every span reader of the benchmark gives a
    number, and no device event carries a span's name (the ranges are
    function-scope, not user annotations the profiler mirrors)."""

    from torch.autograd import DeviceType

    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.models import model_zoo as Z

    trainer, batch = _mixed_trainer(tmp_path, cuda)
    trainer.train_step(batch)          # warm: the kernels built and loaded
    prof, spans = _profiled_on_card(lambda: trainer.train_step(batch))
    names = {s.name for s in spans}
    assert {"trainer.step", "trainer.forward", "trainer.backward", "trainer.optimizer",
            "class_sharded.pod", "class_sharded.epilogue"} <= names
    assert all(s.device_s is not None and s.device_s > 0 for s in spans)
    step = next(s for s in spans if s.name == "trainer.step")
    pods = [s for s in spans if s.name == "class_sharded.pod"]
    assert len(pods) == 2 and all(p.device_s <= step.device_s for p in pods)
    assert not [e.name for e in prof.events()
                if e.device_type != DeviceType.CPU and e.name in names]
    got = _span_readers(["optimizer_share.train", "host_share.train", "pod_balance.train"], [])
    assert all(v is not None and 0 < v for v in got.values()), got
    assert got["optimizer_share.train"] < 100 and got["pod_balance.train"] <= 100
    del trainer, batch
    torch.cuda.empty_cache()

    cfg = get_config("internlm2-1.8b")
    params = Z.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                           dtype=torch.bfloat16)
    prefill = Z.make_prefill_fn(cfg)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), device=cuda)
    ctx = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1).execution_context("big")
    with ctx:
        prefill(params, {"tokens": tokens})
        prof, spans = _profiled_on_card(lambda: prefill(params, {"tokens": tokens}))
    (s,) = spans
    assert s.name == "model.prefill" and s.device_s > 0 and s.args == {"rows": 4, "length": 1024}
    assert not [e for e in prof.events() if e.device_type != DeviceType.CPU
                and e.name == "model.prefill"]
    matmul = sum(p.numel() for p in _tensors(params) if p.ndim >= 2)
    got = _span_readers(["prefill_mfu.score", "host_share.score"],
                        [{"model_flops": 2 * matmul * tokens.numel()}])
    assert all(v is not None and 0 < v for v in got.values()), got
    assert got["prefill_mfu.score"] < 100


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


@pytest.mark.cuda
def test_spans_add_no_host_synchronisation(cuda, tmp_path):
    """``set_sync_debug_mode("warn")`` reports the same synchronising calls,
    at the same lines, in a mixed training step with tracing on as in the
    step before it with tracing off (after two warm steps and a warm
    window)."""

    import collections
    import warnings

    from repro_torch.observability import trace as TRC

    trainer, batch = _mixed_trainer(tmp_path, cuda)
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()

    def syncs(on: bool) -> collections.Counter:
        if on:
            TRC.enable()
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    trainer.train_step(batch)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        finally:
            buf = TRC.disable()
        torch.cuda.synchronize()
        if on:
            assert [e for e in buf.events if e.name == "trainer.step"]
        return collections.Counter(f"{w.filename}:{w.lineno}" for w in seen
                                   if "synchroniz" in str(w.message))

    # The first window of a process reports one more, at the line of
    # ``set_sync_debug_mode`` itself: leave it out.
    runs = [syncs(on) for on in (False, False, True, False, True)][1:]
    assert not [k for run in runs for k in run if "observability" in k]
    assert runs[1] == runs[0] and runs[3] == runs[2], runs
