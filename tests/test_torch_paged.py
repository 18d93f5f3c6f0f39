"""The split plan of ``paged_attention_cuda`` and its walk in eager PyTorch.

``split_plan`` chooses, from shapes alone, how the kernel splits each
row's walk over its cache across blocks; ``paged_attention_split_torch``
is that walk (runs of pages, each an online softmax over position tiles,
then the combine) in PyTorch.  Here, on the CPU, the plan is held to its
contract and the walk to the gather route, the JAX package's Pallas kernel
(``interpret=True``) and its ``paged_attention_ref`` on the same numpy
inputs.

Tolerances (as ``tests/test_backend_parity.py``): fp32 rtol = atol = 1e-4
(the walk and the gather route sum in other orders); bf16 rtol = atol =
2e-2 (the walk rounds ``p`` to bf16 against each run's running max, the
gather route against the row's global max: a bf16 ulp of p either way).
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as JPA
from repro.kernels import ref as JR
from repro.runtime.paging import SENTINEL

from repro_torch.kernels import paged_attention as PA

torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
H100_SMS = 132


def _runs(plan, w, ps):
    return [(k * plan.pages * ps, min((k + 1) * plan.pages, w) * ps) for k in range(plan.n_split)]


# (b, hkv, w, ps): the paged engine's slot (12 rows, 8 KV heads, 3 pages of
# 8), serving's long caches at ps 64 and 16, a single row, many heads,
# pages of one token, and a page count no split divides.
PLAN_SHAPES = [(12, 8, 3, 8), (12, 8, 64, 64), (12, 8, 512, 64), (12, 8, 256, 16), (1, 8, 512, 64),
               (64, 8, 512, 64), (3, 2, 4096, 8), (2, 4, 8192, 1), (5, 3, 97, 16), (1, 1, 1, 1)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("n_sm", [1, H100_SMS])
def test_split_plan_tiles_the_cache_exactly(shape, n_sm):
    b, hkv, w, ps = shape
    plan = PA.split_plan(b, hkv, w, ps, n_sm)
    runs = _runs(plan, w, ps)
    assert runs[0][0] == 0 and runs[-1][1] == w * ps
    assert all(lo < hi for lo, hi in runs)                               # no run is empty
    assert all(a[1] == b_[0] for a, b_ in zip(runs, runs[1:]))           # nor overlaps or leaves a gap
    assert 1 <= plan.pages <= PA.MAX_SPLIT_PAGES
    assert plan.n_split == 1 or plan.pages * ps >= PA.MIN_SPLIT        # no run is shorter than worth a block


def test_split_plan_reads_shapes_only_and_runs_one_split_at_the_engine_shape():
    assert list(inspect.signature(PA.split_plan).parameters) == ["b", "hkv", "w", "ps", "n_sm"]
    # The paged engine's call (phase 3 of chip_smoke.py): 12 rows, 8 KV
    # heads, a 24-token slot of 3 pages of 8 tokens.  One split, one launch.
    assert PA.split_plan(12, 8, 3, 8, H100_SMS) == PA.SplitPlan(n_split=1, pages=3)
    # A cache shorter than two runs of MIN_SPLIT keeps one split whatever the card.
    assert PA.split_plan(1, 1, 4, PA.MIN_SPLIT // 4, 10_000).n_split == 1


@pytest.mark.parametrize("shape", [(12, 8, 64, 64), (12, 8, 512, 64), (12, 8, 256, 16),
                                   (1, 8, 512, 64), (4, 2, 2048, 16)],
                         ids=lambda s: "-".join(map(str, s)))
def test_split_plan_fills_the_card_at_long_caches(shape):
    b, hkv, w, ps = shape
    plan = PA.split_plan(b, hkv, w, ps, H100_SMS)
    assert plan.n_split > 1
    assert b * hkv * plan.n_split >= 2 * H100_SMS


def _inputs(seed, g, b=6, hkv=2, d=16, n_pages=40, ps=4, w=12):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv * g, d)).astype(np.float32)
    pk = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    pv = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    table = rng.integers(0, n_pages, size=(b, w)).astype(np.int32)
    pos = rng.integers(0, w * ps, size=(b,)).astype(np.int32)
    table[0] = SENTINEL           # a dead row: nothing allocated
    pos[1] = w * ps + 5           # a row aged past its cache
    pos[2] = 2                    # a row that ends inside the first page
    pos[3] = 2 * ps - 1           # a row that ends on a page (and a run's) boundary
    pos[4] = w * ps - 1           # a full row
    return q, pk, pv, table, pos


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("pages", [1, 2, 5, 12])
def test_split_walk_matches_gather_route_pallas_interpret_and_ref(pages, g, dt):
    q, pk, pv, table, pos = _inputs(pages + 10 * g, g)
    w = table.shape[1]
    plan = PA.SplitPlan(math.ceil(w / pages), pages)
    tq, tk, tv = (torch.from_numpy(x).to(TORCH_DT[dt]) for x in (q, pk, pv))
    tt, tp = torch.from_numpy(table), torch.from_numpy(pos)
    jq, jk, jv = (jnp.asarray(x, JAX_DT[dt]) for x in (q, pk, pv))
    jt, jp = jnp.asarray(table), jnp.asarray(pos)

    got = PA.paged_attention_split_torch(tq, tk, tv, tt, tp, plan)
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == q.shape
    for want in (PA.paged_attention_torch(tq, tk, tv, tt, tp),
                 JPA.paged_attention_pallas(jq, jk, jv, jt, jp, interpret=True),
                 JR.paged_attention_ref(jq, jk, jv, jt, jp)):
        want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, **TOLS[dt])


def test_split_partials_leave_runs_past_the_limit_empty():
    q, pk, pv, table, pos = (torch.from_numpy(x) for x in _inputs(7, 2))
    plan = PA.SplitPlan(6, 2)  # runs of 8 positions
    m, l, acc = PA.split_partials(q, pk, pv, table, pos, plan)
    limit = torch.clamp(pos.long() + 1, max=table.shape[1] * pk.shape[1])
    for row in range(q.shape[0]):
        for k in range(plan.n_split):
            empty = k * plan.pages * pk.shape[1] >= limit[row]
            assert bool((m[row, k] == PA.NEG_INF).all()) == empty
            assert bool((l[row, k] == 0).all()) == empty
            if empty:
                assert bool((acc[row, k] == 0).all())
