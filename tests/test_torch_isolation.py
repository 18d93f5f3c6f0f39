"""The PyTorch port stands alone: no ``jax``, nothing of ``repro``.

Every module under ``src/repro_torch/``, the root ``chip_smoke.py`` and
the card-only ``tests/test_torch_cuda.py`` are scanned (AST) for imports
of ``jax``/``jaxlib`` or the JAX package ``repro``; then a fresh
interpreter imports every port module and checks that neither ended up in
``sys.modules``.  The framework-neutral modules the port carries over as
copies are held to the reference's text, their import lines renamed to the
port's package; the port's own trace module keeps the reference's
surface.  No tolerances: these are structural checks.
"""

import ast
import difflib
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_covers_the_slice_modules():
    mods = set(_port_modules())
    for name in (
        "repro_torch.util.atomic", "repro_torch.observability.trace",
        "repro_torch.core.blocking", "repro_torch.core.schedule",
        "repro_torch.core.execution", "repro_torch.core.control_tree",
        "repro_torch.core.asymmetric", "repro_torch.kernels.ref",
        "repro_torch.kernels.gemm", "repro_torch.kernels.paged_attention",
        "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd",
        "repro_torch.configs.minitron_4b",
        "repro_torch.configs.deepseek_7b", "repro_torch.configs.qwen2p5_32b",
        "repro_torch.kernels.ops", "repro_torch.configs",
        "repro_torch.configs.internlm2_1p8b", "repro_torch.models.layers",
        "repro_torch.models.transformer", "repro_torch.models.model_zoo",
        "repro_torch.runtime.paging", "repro_torch.runtime.serving",
        "repro_torch.launch.serve", "repro_torch.convert",
        "repro_torch.core.simulator", "repro_torch.observability.metrics",
        "repro_torch.observability.probe", "repro_torch.observability.report",
        "repro_torch.tuning", "repro_torch.tuning.cache", "repro_torch.tuning.candidates",
        "repro_torch.tuning.measure", "repro_torch.tuning.ratio", "repro_torch.tuning.tune",
        "repro_torch.models.moe", "repro_torch.configs.qwen2_moe_a2p7b",
        "repro_torch.configs.mixtral_8x7b", "repro_torch.models.ssm",
        "repro_torch.models.encdec", "repro_torch.configs.mamba2_1p3b",
        "repro_torch.configs.zamba2_2p7b", "repro_torch.configs.whisper_small",
        "repro_torch.configs.pixtral_12b", "repro_torch.launch.score",
        "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.data",
        "repro_torch.data.pipeline", "repro_torch.checkpoint",
        "repro_torch.checkpoint.checkpointer", "repro_torch.runtime.trainer",
        "repro_torch.launch.train", "repro_torch.launch.mesh", "repro_torch.distributed",
        "repro_torch.distributed.sharding", "repro_torch.distributed.collectives",
        "repro_torch.runtime.faults", "repro_torch.runtime.fleet",
        "repro_torch.analysis", "repro_torch.analysis.__main__",
        "repro_torch.analysis.ast_checks", "repro_torch.analysis.cli",
        "repro_torch.analysis.configcheck", "repro_torch.analysis.diagnostics",
        "repro_torch.analysis.donation", "repro_torch.analysis.registry",
        "repro_torch.launch.op_analysis", "repro_torch.launch.dryrun",
        "repro_torch.launch.roofline",
    ):
        assert name in mods, name
    for src in ("gemm.cu", "paged_attention.cu", "flash_attention.cu", "ssd_scan.cu"):
        assert (PORT / "csrc" / src).is_file(), src


# Copies of the reference's framework-neutral modules: the same text, the
# import lines of the reference's package renamed to the port's.
COPIES = ("runtime/faults.py", "runtime/fleet.py", "runtime/paging.py", "util/atomic.py",
          "observability/metrics.py", "observability/report.py",
          "core/schedule.py", "core/simulator.py")


# Copies that differ from the reference in a counted number of lines, each
# replaced by one: the analyzer's diagnostic model reads the port's own
# suppression comment (``# repro_torch: noqa=...``) and gives some codes
# their port meaning.
DIFFERING = {"analysis/diagnostics.py": 15}


@pytest.mark.parametrize("rel", COPIES + tuple(DIFFERING))
def test_copied_module_matches_reference(rel):
    ref = (ROOT / "src" / "repro" / rel).read_text()
    want = re.sub(r"^(\s*)(from|import) repro([ .])", r"\1\2 repro_torch\3", ref, flags=re.M)
    got = (PORT / rel).read_text()
    if rel not in DIFFERING:
        assert got == want, f"{rel} drifted from src/repro/{rel}"
        return
    diff = list(difflib.unified_diff(want.splitlines(), got.splitlines(), n=0, lineterm=""))
    added = [d for d in diff if d.startswith("+") and not d.startswith("+++")]
    removed = [d for d in diff if d.startswith("-") and not d.startswith("---")]
    assert len(added) == len(removed) == DIFFERING[rel], "\n".join(diff)


def test_trace_keeps_the_reference_surface(tmp_path):
    """``observability/trace.py`` is the port's own (ids, device time, the
    profiler's clock), no longer a copy: it still exports every name of
    the reference's ``__all__``, and the copied ``report.py`` loads what
    its buffer saves."""

    from repro.observability import trace as JT
    from repro_torch.observability import report
    from repro_torch.observability import trace as TT

    assert set(JT.__all__) <= set(TT.__all__)
    assert all(hasattr(TT, name) for name in TT.__all__)
    TT.enable()
    try:
        with TT.span("outer", cat="engine", k=1):
            with TT.span("outer", cat="engine"):
                TT.instant("mark", cat="engine", pages=2)
    finally:
        buf = TT.disable()
    path = str(tmp_path / "t.json")
    buf.save(path)
    events, meta = report.load_events(path)
    assert meta["format"] == "native" and meta["skipped_records"] == 0
    assert [e["name"] for e in events] == ["mark", "outer", "outer"]
    inner, outer = events[1], events[2]
    assert inner["parent"] == outer["id"] and inner["parent_name"] == "outer"
    assert "outer" in report.summarize(events)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
