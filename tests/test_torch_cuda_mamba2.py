"""Mamba2-1.3B as published, one training step on a card at the benchmark
cell's shapes (4 x 2,048): the scan's spans and counter against the
frozen counts, as the GEMM launch counters are held to theirs, and every
scan through the SSD kernels (``kernels/ssd.LAUNCHES``), none through
``_ssd_chunked`` (``layers.CUDA_CALLS``).

Marked ``cuda``; skips without a card.  The file imports neither ``jax``
nor the JAX package; on the card's machine run it without the conftest::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_mamba2.py
"""

import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ROWS, SEQ = 4, 2048


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_published_mamba2_step_spans_and_counts(cuda, tmp_path):
    from portbench import run as RUN
    from repro_torch.kernels import gemm as G
    from repro_torch.kernels import ssd as SSD
    from repro_torch.launch import train as LT
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.observability import trace

    args = LT.build_parser().parse_args(
        ["--arch", "mamba2-1.3b-published", "--device", "cuda", "--global-batch", str(ROWS),
         "--seq", str(SEQ), "--steps", "10", "--strategy", "ca-das", "--heterogeneous",
         "--class-sharded", "off", "--ckpt-dir", str(tmp_path), "--ckpt-every", str(10 ** 9)])
    trainer = LT.make_trainer(args)
    cfg = trainer.arch
    gen = torch.Generator(device=cuda).manual_seed(5)
    tokens = torch.randint(0, 50277, (ROWS, SEQ + 1), generator=gen, device=cuda)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    trainer.train_step(batch)                  # builds the kernels
    torch.cuda.synchronize()
    trace.profiled_spans()
    S.reset_scans()
    G.reset_launches()
    SSD.reset_launches()
    L.CUDA_CALLS["ssd_chunked"] = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        metrics = trainer.train_step(batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
    spans = trace.profiled_spans()
    nl, chunks = cfg.n_layers, SEQ // cfg.ssm.chunk
    assert (nl, chunks) == (48, 8)
    assert S.SCANS == {"calls": 2 * nl, "chunks": 2 * nl * chunks}      # 96, 768
    assert G.LAUNCHES == {"gemm_cuda": 3, "gemm_cuda_lean": 0}          # the tied head's three
    # Every scan through the kernels (forward and recompute), every backward
    # through the backward kernels, none through _ssd_chunked.
    assert SSD.LAUNCHES["ssd_scan_cuda"] == S.SCANS["calls"] == 2 * nl
    assert all(SSD.LAUNCHES[k] == 2 * nl for k in SSD.FWD_KERNELS)
    assert all(SSD.LAUNCHES[k] == nl for k in SSD.BWD_KERNELS)
    assert L.CUDA_CALLS["ssd_chunked"] == 0
    scans = [s for s in spans if s.name == "ssm.scan"]
    back = [s for s in spans if s.name == "ssm.scan.backward"]
    phases = [s.args["phase"] for s in scans]
    assert phases.count("forward") == nl and phases.count("recompute") == nl
    assert len(back) == nl
    assert all(s.device_s is not None and s.device_s > 0 for s in scans + back)
    tags = dict(rows=ROWS, seq=SEQ, heads=64, headdim=64, d_state=128, groups=1, chunk=256)
    assert all({k: s.args[k] for k in tags} == tags for s in scans + back)
    run = {"peaks": RUN.counts.peaks()}
    share = RUN.load_reader("ssd_share.train")(run)
    roof = RUN.load_reader("ssd_roofline.train")(run)
    print(f"ssd_share {share:.2f}% ssd_roofline {roof:.3f}% "
          f"forward {sum(s.device_s for s in scans if s.args['phase'] == 'forward'):.4f} s "
          f"recompute {sum(s.device_s for s in scans if s.args['phase'] == 'recompute'):.4f} s "
          f"backward {sum(s.device_s for s in back):.4f} s")
    assert 0 < share <= 100 and 0 < roof <= 100
