"""No module that the benchmark runs is JAX, the JAX package or the old
benchmarks: a whole run on the CPU, at the reduced sizes, in a fresh
interpreter, then its modules' top-level names compared whole."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCRIPT = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
from cells import reduced_cell
from portbench import calibrate, run, tracing, readers, counts
cell = reduced_cell({name!r})
run.run_cell(cell, 2**33 + 1, 0.3, True, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(name):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = SCRIPT.format(root=ROOT, src=os.path.join(ROOT, "src"),
                         tests=os.path.dirname(os.path.abspath(__file__)), name=name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_a_training_run():
    mods = _modules("internlm2-1.8b.train")
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_no_jax_in_a_scoring_run():
    mods = _modules("internlm2-1.8b.score")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    from portbench import run as RUN

    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert RUN.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro.models")
    assert "repro" not in RUN.forbidden_modules()
