"""Port vs reference: the GEMM and paged-attention kernels' plain versions.

Inputs are drawn with numpy from a seed and handed to both packages.  The
JAX side runs its Pallas kernels as its own tests do on the CPU
(``interpret=True``) and its ``kernels/ref.py`` oracles.  On the CPU the
port's kernel wrappers run their plain PyTorch versions (the tensors lie
on the CPU); the CUDA kernels themselves are held against those plain
versions in ``test_torch_cuda.py``, on a card.

Tolerances (as ``tests/test_backend_parity.py``): fp32 rtol = atol = 1e-4;
bf16 rtol = atol = 2e-2 (bf16 operands and outputs round to 8 mantissa
bits; both sides accumulate in fp32).  Within the port, the lean GEMM
equals the pipelined one bitwise at equal blocks, and the gather route
equals the dense decode attention bitwise on equal cache values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.blocking import BlockConfig as JBlock
from repro.kernels import gemm as JG
from repro.kernels import paged_attention as JPA
from repro.kernels import ref as JR
from repro.runtime.paging import SENTINEL

from repro_torch.core import execution as X
from repro_torch.core.blocking import BlockConfig
from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L

torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (m, k, n) and one block for both packages: ragged in every dim.
GEMM_CASES = [
    ((16, 64, 32), (16, 32, 32)),
    ((40, 100, 70), (32, 64, 32)),
    ((12, 96, 160), (16, 48, 64)),
    ((1, 16, 1), (16, 16, 32)),
]


def _pair(a: np.ndarray, dt: str):
    return jnp.asarray(a, JAX_DT[dt]), torch.from_numpy(a).to(TORCH_DT[dt])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dt):
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dt])


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block", GEMM_CASES, ids=lambda v: "x".join(map(str, v)))
def test_gemm_plain_versions_match_pallas_interpret(shape, block, dt):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + n)
    a_np = rng.normal(size=(m, k)).astype(np.float32)
    b_np = rng.normal(size=(k, n)).astype(np.float32)
    ja, ta = _pair(a_np, dt)
    jb, tb = _pair(b_np, dt)
    bm, bk, bn = block
    jcfg, tcfg = JBlock(bm=bm, bk=bk, bn=bn), BlockConfig(bm=bm, bk=bk, bn=bn)

    pipelined = JG.gemm_pallas(ja, jb, jcfg, interpret=True)
    lean = JG.gemm_pallas_lean(ja, jb, jcfg, interpret=True)
    for got in (G.gemm_plain(ta, tb, tcfg), G.gemm_cuda(ta, tb, tcfg)):
        _close(got, pipelined, dt)
        _close(got, JR.gemm_ref(ja, jb), dt)
        assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == (m, n)
    for got in (G.gemm_lean_plain(ta, tb, tcfg), G.gemm_cuda_lean(ta, tb, tcfg)):
        _close(got, lean, dt)
    _close(R.blocked_gemm_tile_ref(ta, tb, tcfg), JR.blocked_gemm_tpu_ref(ja, jb, jcfg), dt)
    _close(R.gemm_ref(ta, tb), JR.gemm_ref(ja, jb), dt)


@pytest.mark.parametrize("goto", [(152, 952, 4096, 4, 4), (32, 40, 24, 4, 4), (8, 16, 12, 2, 3)],
                         ids=lambda v: "x".join(map(str, v)))
def test_blocked_gemm_ref_matches_reference(goto):
    """The paper's Figure 1 loop nest: the same numpy loops in both
    packages, so equal bitwise; and within fp32 rounding of one product."""

    from repro.core.blocking import GotoBlocking as JGoto
    from repro_torch.core.blocking import GotoBlocking

    mc, kc, nc, mr, nr = goto
    rng = np.random.default_rng(mc + kc)
    a = rng.normal(size=(70, 90)).astype(np.float32)
    b = rng.normal(size=(90, 50)).astype(np.float32)
    got = R.blocked_gemm_ref(a, b, GotoBlocking(mc=mc, kc=kc, nc=nc, mr=mr, nr=nr))
    want = JR.blocked_gemm_ref(a, b, JGoto(mc=mc, kc=kc, nc=nc, mr=mr, nr=nr))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    np.testing.assert_allclose(got, a @ b, **TOLS["float32"])


@pytest.mark.parametrize("shape,block", GEMM_CASES, ids=lambda v: "x".join(map(str, v)))
def test_lean_equals_pipelined_bitwise_at_equal_blocks(shape, block):
    m, k, n = shape
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).bfloat16()
    cfg = BlockConfig(*block)
    for out_dtype in (None, torch.float32):
        pipe = G.gemm_cuda(a, b, cfg, out_dtype=out_dtype)
        assert torch.equal(G.gemm_cuda_lean(a, b, cfg, out_dtype=out_dtype), pipe)
        assert torch.equal(G.gemm_lean_plain(a, b, cfg, out_dtype=out_dtype), pipe)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    G.reset_launches()
    PA.reset_launches()
    a = torch.ones((4, 16), dtype=torch.bfloat16)
    G.gemm_cuda(a, a.T.contiguous())
    G.gemm_cuda_lean(a, a.T.contiguous())
    assert G.LAUNCHES == {"gemm_cuda": 0, "gemm_cuda_lean": 0}
    assert PA.LAUNCHES == {"paged_attention_cuda": 0}


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises."""

    a = torch.empty((4, 16), dtype=torch.bfloat16, device="meta")
    b = torch.empty((16, 32), dtype=torch.bfloat16, device="meta")
    for fn in (G.gemm_cuda, G.gemm_cuda_lean):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(a, b, BlockConfig(16, 16, 32))
    q = torch.empty((2, 4, 16), dtype=torch.bfloat16, device="meta")
    pages = torch.empty((3, 4, 2, 16), dtype=torch.bfloat16, device="meta")
    table = torch.empty((2, 2), dtype=torch.int32, device="meta")
    pos = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        PA.paged_attention_cuda(q, pages, pages, table, pos)


def test_pipelined_ring_is_as_deep_as_shared_memory_allows():
    """The pipelined kernel keeps PIPELINE_STAGES stages, or the most (at
    least two) that fit a block's shared memory; the lean kernel one."""

    from repro_torch.core.blocking import PIPELINE_STAGES

    assert PIPELINE_STAGES == 4
    assert G.ring_depth(BlockConfig(128, 64, 256)) == 4       # 196,672 B
    assert G.ring_depth(BlockConfig(128, 128, 128)) == 3      # 4 stages: 262,208 B
    assert G.ring_depth(BlockConfig(128, 128, 256)) == 2
    with pytest.raises(ValueError, match="shared memory"):
        G.ring_depth(BlockConfig(128, 256, 256))              # only the lean ring holds it


@pytest.mark.parametrize("arch,rows", [("internlm2-1.8b", 12), ("minitron-4b", 4096)])
def test_main_path_blocks_fit_the_pipelined_ring(arch, rows):
    """The big class's blocks at every GEMM shape of the decode step
    (M = 12) and of the forward (M = 4096) fit a ring of
    ``PIPELINE_STAGES``.  The shallower rings of :func:`ring_depth` serve
    only the little class's lean panels, where ``chip_smoke.py`` holds
    lean == pipelined bitwise: each fits a ring of at least two."""

    from repro_torch.configs import get_config
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
    from repro_torch.core.blocking import H100, PIPELINE_STAGES

    assert PIPELINE_STAGES == 4
    cfg = get_config(arch)
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1, backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    big, little = mesh.execution_context("big"), mesh.execution_context("little")
    assert (big.backend(), little.backend()) == ("cuda", "cuda_lean")
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    for k, n in ((d, hq), (d, hkv), (hq, d), (d, cfg.d_ff), (cfg.d_ff, d), (d, cfg.vocab)):
        blk = big.block_config(rows, k, n, "bfloat16", 2)
        assert blk.smem_bytes(PIPELINE_STAGES) <= H100.smem_bytes, (arch, rows, k, n, blk)
        assert G.ring_depth(little.block_config(rows, k, n, "bfloat16", 2)) >= 2


def test_gemm_rejects_bad_operands():
    a = torch.ones((4, 16))
    with pytest.raises(ValueError, match="inner dims"):
        G.gemm_cuda(a, torch.ones((8, 4)))
    with pytest.raises(ValueError, match="2-D"):
        G.gemm_cuda(a[None], torch.ones((16, 4)))


def test_ops_gemm_takes_backend_and_blocks_from_the_context():
    from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rng.normal(size=(48,)).astype(np.float32))
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1, backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    for name, plain in (("big", G.gemm_plain), ("little", G.gemm_lean_plain)):
        ctx = mesh.execution_context(name)
        with ctx:
            got = ops.gemm(x, w)
            lin = ops.linear(x, w, bias)
        cfg = ctx.block_config(6, 64, 48, "bfloat16", 2)
        want = plain(x.reshape(6, 64), w, cfg).reshape(2, 3, 48)
        assert torch.equal(got, want)
        assert torch.equal(lin, (want.float() + bias).bfloat16())
    # No context: "auto" is the framework matmul without a card.
    assert X.resolve_backend("auto") == ("cuda" if torch.cuda.is_available() else "matmul")
    np.testing.assert_allclose(_np(ops.gemm(x, w)), _np(R.gemm_ref(x.reshape(6, 64), w)).reshape(2, 3, 48),
                               **TOLS["bfloat16"])
    with pytest.raises(ValueError, match="2-D rhs"):
        ops.gemm(x, w[None])


def test_registry_is_closed():
    assert X.validate_registry() == []
    assert set(G.GEMM_KERNELS) == {"cuda", "cuda_lean"}
    assert X.plain_twin("cuda") == "torch_ref" and X.plain_twin("paged_attn_cuda") == "paged_attn_torch"
    assert X.backend_stages("cuda") == 4 and X.backend_stages("cuda_lean") == 1
    with pytest.raises(ValueError, match="not a GEMM"):
        X.resolve_backend("paged_attn_cuda")  # repro: noqa=RPR005 -- a negative test: a name of the other op family must raise
    with pytest.raises(ValueError, match="not a paged-attention"):
        X.resolve_paged_attn_backend("cuda")  # repro: noqa=RPR005 -- a negative test: a name of the other op family must raise
    with pytest.raises(ValueError, match="unknown backend"):
        X.resolve_backend("pallas")  # repro_torch: noqa=RPR005 -- negative test: the reference's name must raise


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------


def _paged_inputs(seed, b=5, hq=4, hkv=2, d=16, n_pages=9, ps=4, w=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    pk = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    pv = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    table = rng.integers(0, n_pages, size=(b, w)).astype(np.int32)
    pos = rng.integers(0, w * ps, size=(b,)).astype(np.int32)
    table[0] = SENTINEL           # a dead row: nothing allocated
    table[1, 2] = SENTINEL        # a partly allocated row, masked past pos
    pos[1] = min(pos[1], 2 * ps - 1)
    pos[2] = w * ps + 5           # a row aged past its cache
    return q, pk, pv, table, pos


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_attention_plain_matches_pallas_interpret_and_ref(seed, dt):
    q, pk, pv, table, pos = _paged_inputs(seed)
    jq, tq = _pair(q, dt)
    jk, tk = _pair(pk, dt)
    jv, tv = _pair(pv, dt)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)

    pallas = JPA.paged_attention_pallas(jq, jk, jv, jt, jp, interpret=True)
    for got in (PA.paged_attention_torch(tq, tk, tv, tt, tp), PA.paged_attention_cuda(tq, tk, tv, tt, tp)):
        assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == q.shape
        _close(got, pallas, dt)
        _close(got, JR.paged_attention_ref(jq, jk, jv, jt, jp), dt)
        _close(got, JPA.paged_attention_xla(jq, jk, jv, jt, jp), dt)
    _close(R.paged_attention_ref(tq, tk, tv, tt, tp), JR.paged_attention_ref(jq, jk, jv, jt, jp), dt)
    _close(PA.paged_gather(tk, tt), JPA.paged_gather(jk, jt), dt)


def test_paged_attention_ignores_whatever_lies_behind_masked_pages():
    q, pk, pv, table, pos = _paged_inputs(3)
    args = [torch.from_numpy(x) for x in (q, pk, pv, table, pos)]
    base = PA.paged_attention_torch(*args)
    # Scribble over every page no row attends.
    attended = {int(table[r, c]) for r in range(len(pos)) for c in range(table.shape[1])
                if c * pk.shape[1] < min(pos[r] + 1, table.shape[1] * pk.shape[1])
                and table[r, c] != SENTINEL}
    attended.add(pk.shape[0] - 1)  # clipped sentinels read the last page
    junk = [p for p in range(pk.shape[0]) if p not in attended]
    args[1][junk] = 1e4
    args[2][junk] = -1e4
    assert torch.equal(PA.paged_attention_torch(*args), base)


def test_gather_route_equals_dense_decode_attention_bitwise():
    """The reference's contract: on equal cache values the paged gather
    route reproduces the dense decode path bit for bit."""

    rng = np.random.default_rng(4)
    b, d, hq, hkv, dh, ps, w = 4, 32, 4, 2, 8, 4, 3
    s_cache = ps * w
    cfg = L.AttnConfig(d_model=d, n_heads=hq, n_kv_heads=hkv, d_head=dh)
    gen = torch.Generator().manual_seed(0)
    p = L.init_attention(gen, cfg, device="cpu")
    x = torch.from_numpy(rng.normal(size=(b, 1, d)).astype(np.float32)).bfloat16()
    dense_k = torch.from_numpy(rng.normal(size=(b, s_cache, hkv, dh)).astype(np.float32)).bfloat16()
    dense_v = torch.from_numpy(rng.normal(size=(b, s_cache, hkv, dh)).astype(np.float32)).bfloat16()
    pos = torch.tensor([0, 5, s_cache - 1, 7], dtype=torch.int32)
    live = torch.tensor([True, True, False, True])

    # The same values laid out in a shuffled page arena.
    perm = torch.from_numpy(rng.permutation(b * w).astype(np.int64))
    table = perm.reshape(b, w).to(torch.int32)
    pages_k = torch.zeros((b * w, ps, hkv, dh), dtype=torch.bfloat16)
    pages_v = torch.zeros_like(pages_k)
    pages_k[table.long()] = dense_k.reshape(b, w, ps, hkv, dh)
    pages_v[table.long()] = dense_v.reshape(b, w, ps, hkv, dh)

    want, (ck, _) = L.decode_attention(p, x, cfg, dense_k, dense_v, pos, live=live)
    got, (pk, _) = L.decode_attention_paged(p, x, cfg, pages_k, pages_v, table, pos,
                                            live=live, backend="paged_attn_torch")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert torch.equal(got, want)
    assert torch.equal(PA.paged_gather(pk, table), ck)  # the writes landed alike
