"""Tests for ``repro_torch.analysis``, the port's static verifier.

The port of ``tests/test_analysis.py``, class by class: registry
contracts, the fixture corpus, config contracts, the CLI, the diagnostic
model.  The dirty corpus is written as strings into ``tmp_path``, so
neither analyzer's scan of the repo ever sees it; each flagged line
carries an ``# expect: RPR0xx`` marker the tests read.  Suppression
comments inside the corpus are assembled at run time (``_noqa``), so this
file itself carries none that either analyzer would read.
"""

import json
import os
import textwrap

import pytest

from repro_torch.analysis import CODES, Diagnostic, analyze_file
from repro_torch.analysis import ast_checks, configcheck, registry
from repro_torch.analysis import cli as analysis_cli
from repro_torch.analysis.diagnostics import format_github, format_json, render
from repro_torch.core import execution as X

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _noqa(pkg: str, codes: str, reason: str = "") -> str:
    text = "# " + pkg + ": noqa=" + codes
    return text + (" -- " + reason if reason else "")


PORT_NOQA = lambda codes, reason="": _noqa("repro_torch", codes, reason)  # noqa: E731
REF_NOQA = lambda codes, reason="": _noqa("repro", codes, reason)  # noqa: E731

# Each entry: file name -> source.  Lines the analyzer must flag end in
# ``# expect: CODE``.
CORPUS = {
    "inplace_pin.py": '''
        """In-place state: copy pins (RPR002) and read-after-update (RPR001)."""

        import numpy as np

        from repro_torch.models import model_zoo as Z
        from repro_torch.optim import adamw as O

        DECODE = Z.make_decode_fn(None)
        PREFILL = Z.make_prefill_fn(None, with_cache=True)
        SCORE = Z.make_prefill_fn(None)


        def pinned_direct(params, batch, state, pos):
            return DECODE(params, batch, state.clone(), pos)  # expect: RPR002


        def pinned_via_name(params, batch, state, pos):
            host = np.asarray(state)  # expect: RPR002
            logits, host = DECODE(params, batch, host, pos)
            return logits


        def pinned_optimizer(params, grads, opt_state, cfg):
            return O.adamw_update(params, grads, opt_state.cpu(), cfg)  # expect: RPR002


        def read_after_update(params, grads, opt_state, cfg):
            new_params, new_state, om = O.adamw_update(params, grads, opt_state, cfg)
            return opt_state["step"]  # expect: RPR001


        def read_after_prefill(params, batch, state):
            logits, _ = PREFILL(params, batch, state, 0)
            return state  # expect: RPR001


        def safe(params, batch, state, pos):
            logits, state = DECODE(params, batch, state, pos)
            scores = SCORE(params, batch.clone())
            return logits, state, scores
    ''',
    "compiled_in_loop.py": '''
        """A compiled callable built per loop iteration (RPR003)."""

        import torch

        from repro_torch.kernels import build


        def rebuilds_every_pass(xs, f):
            outs = []
            for x in xs:
                g = torch.compile(f)  # expect: RPR003
                s = torch.jit.script(f)  # expect: RPR003
                lib = build.load("gemm")  # expect: RPR003
                outs.append((g(x), s, lib))
            while outs:
                t = torch.jit.trace(f, outs.pop())  # expect: RPR003
            return t


        def hoisted_is_fine(xs, f):
            g = torch.compile(f)
            return [g(x) for x in xs]


        def nested_def_resets_scope(xs, f):
            for _ in xs:
                def helper(v):
                    return torch.compile(f)(v)
            return helper
    ''',
    "contextvar_set.py": '''
        """Raw ContextVar.set outside the blessed helpers (RPR004)."""

        import contextvars

        _MODE = contextvars.ContextVar("mode", default=None)


        def leaks_ambient_state(mode):
            _MODE.set(mode)  # expect: RPR004
            return _MODE.get()


        def paired_with_finally(mode):
            token = _MODE.set(mode)
            try:
                return _MODE.get()
            finally:
                _MODE.reset(token)


        class ModeScope:
            def __init__(self, mode):
                self._mode = mode
                self._token = None

            def __enter__(self):
                self._token = _MODE.set(self._mode)
                return self

            def __exit__(self, *exc):
                _MODE.reset(self._token)
                return False
    ''',
    "backend_drift.py": f'''
        """Backend-name drift against the port's registry (RPR005)."""

        from repro_torch.core.execution import BACKENDS, PLAIN_TWIN, plain_twin, resolve_backend
        from repro_torch.models import model_zoo as Z


        def pick(backend, cfg):
            if backend == "cuda_lena":  # expect: RPR005
                return run(backend="cuda_lena")  # expect: RPR005
            fn = BACKENDS["pallas"]  # expect: RPR005
            twin = PLAIN_TWIN["torch_reff"]  # expect: RPR005
            resolve_backend("pallas_lean")  # expect: RPR005
            plain_twin("xla")  # expect: RPR005
            Z.make_prefill_fn(cfg, attn_backend="flash_attn_cud")  # expect: RPR005
            if backend in ("cuda", "cuda_lena"):  # expect: RPR005
                return fn, twin
            if backend == "cuda_lena":  {REF_NOQA("RPR005", "the reference's comment does not silence the port")}  # expect: RPR005
                return twin
            return fn


        def valid_tokens_pass(backend, cfg):
            if backend == "cuda_lean":
                return run(backend="matmul")
            Z.make_prefill_fn(cfg, attn_backend="flash_attn_torch")
            plain_twin("cuda")
            return resolve_backend("auto"), BACKENDS["paged_attn_cuda"]


        def run(backend):
            return backend
    ''',
    "objective_drift.py": '''
        """Scheduling-objective drift (RPR005, objective arm)."""

        from repro_torch.core.schedule import validate_objective


        def pick(objective, ap):
            if objective == "engery":  # expect: RPR005
                return run(objective="performance")  # expect: RPR005
            validate_objective("edp2")  # expect: RPR005
            ap.add_argument("--objective", choices=("perf", "energy", "edp2"))
            if objective == "energy":
                return run(objective="perf")
            validate_objective("edp")
            return objective


        def run(objective):
            return objective
    ''',
    "fault_point_drift.py": '''
        """Fault-point drift against the port's FAULT_POINTS (RPR006)."""

        from repro_torch.runtime.faults import FAULT_POINTS, FaultEvent, fault_active, validate_point


        def plan_tick(engine, tick):
            if fault_active("pod_deth", engine=engine, tick=tick):  # expect: RPR006
                return None
            validate_point("engine_stalled")  # expect: RPR006
            ev = FaultEvent(point="admission_failure", engine=engine, tick=tick)  # expect: RPR006
            doc = FAULT_POINTS["latency_spikes"]  # expect: RPR006
            return ev, doc


        def valid_tokens_pass(engine, tick):
            if fault_active("pod_death", engine=engine, tick=tick):
                return None
            validate_point("engine_stall")
            return FaultEvent(point="admission_fail", engine=engine, tick=tick), FAULT_POINTS["latency_spike"]
    ''',
    "suppressed.py": f'''
        """Suppression semantics: justified, reason-less, on a continuation line."""

        import torch


        def justified(xs, f):
            for x in xs:
                g = torch.compile(f)  {PORT_NOQA("RPR003", "shapes change every pass anyway")}
                yield g(x)


        def reasonless(xs, f):
            for x in xs:
                g = torch.compile(f)  {PORT_NOQA("RPR003")}  # expect: RPR000
                yield g(x)


        def continuation_line(xs, f):
            for x in xs:
                g = torch.compile(
                    f,
                    dynamic=False,
                )  {PORT_NOQA("RPR003", "the noqa rides the closing paren")}
                yield g(x)
    ''',
    "clean.py": '''
        """Idiomatic port code every pass leaves untouched."""

        import numpy as np
        import torch

        from repro_torch.models import model_zoo as Z

        DECODE = Z.make_decode_fn(None)


        def serve(params, batches, state, pos):
            for batch in batches:
                logits, state = DECODE(params, batch, state, pos)
            return logits, state


        def export(state):
            return np.asarray(state["k"].cpu())


        def pick(backend):
            if backend == "cuda_lean":
                return torch.zeros(1)
            return None
    ''',
}


def _source(name: str) -> str:
    return textwrap.dedent(CORPUS[name]).lstrip("\n")


def expected(name: str) -> list:
    out = []
    for i, line in enumerate(_source(name).splitlines(), start=1):
        if "# expect: " in line:
            out.append((line.split("# expect: ")[1].strip(), i))
    return sorted(out)


def code_lines(diags):
    return sorted((d.code, d.line) for d in diags)


@pytest.fixture
def corpus(tmp_path):
    """The dirty corpus, written into ``tmp_path``; returns ``name -> path``."""

    paths = {}
    for name in CORPUS:
        p = tmp_path / name
        p.write_text(_source(name))
        paths[name] = str(p)
    return paths


def _cache(tmp_path, entries, name="cache.json", version=1):
    p = tmp_path / name
    p.write_text(json.dumps({"version": version, "entries": entries}))
    return str(p)


GOOD_ENTRIES = {
    "h100/bfloat16/512x256x512": {
        "bm": 128, "bk": 128, "bn": 128, "dtype_bytes": 2, "acc_bytes": 4,
        "backend": "cuda", "shape": [512, 256, 512],
    },
    "h100-little/bfloat16/208x208x208": {
        "bm": 64, "bk": 192, "bn": 128, "dtype_bytes": 2, "acc_bytes": 4,
        "backend": "cuda_lean", "shape": [200, 200, 200],
    },
}


# ---------------------------------------------------------------------------
# Registry contracts
# ---------------------------------------------------------------------------


class TestRegistryContracts:
    def test_validate_registry_clean(self):
        assert X.validate_registry() == []

    def test_registry_check_clean(self):
        assert registry.check_registry() == []

    def test_shipped_trees_clean(self):
        assert configcheck.check_shipped_trees() == []

    def test_vocabulary_spans_both_registries(self):
        vocab = analysis_cli.build_vocabulary()
        assert {"matmul", "cuda", "cuda_lean", "torch_ref", "flash_attn_torch",
                "paged_attn_cuda", "auto"} <= vocab
        assert {"cost-model", "wallclock"} <= vocab
        assert "pallas" not in vocab and "xla" not in vocab

    def test_fault_point_vocabulary_tracks_live_registry(self):
        from repro_torch.runtime.faults import FAULT_POINTS

        assert analysis_cli.build_fault_points() == frozenset(FAULT_POINTS)

    def test_broken_plain_twin_is_rpr101(self, monkeypatch):
        monkeypatch.setitem(X.PLAIN_TWIN, "cuda", "paged_attn_torch")
        diags = registry.check_registry()
        assert diags and {d.code for d in diags} == {"RPR101"}
        assert all(d.path == "src/repro_torch/core/execution.py" for d in diags)

    def test_family_escape_is_rpr102(self, monkeypatch):
        monkeypatch.setattr(X, "align_backend_family", lambda variant, requested: "flash_attn_torch")
        diags = registry.check_registry()
        assert diags and {d.code for d in diags} == {"RPR102"}
        assert any("escapes the family" in d.message for d in diags)


# ---------------------------------------------------------------------------
# AST passes over the corpus
# ---------------------------------------------------------------------------


class TestFixtureCorpus:
    @pytest.mark.parametrize("name", ["inplace_pin.py", "compiled_in_loop.py",
                                      "contextvar_set.py", "backend_drift.py",
                                      "objective_drift.py", "fault_point_drift.py",
                                      "suppressed.py"])
    def test_each_bug_class_under_its_code(self, corpus, name):
        diags = analyze_file(corpus[name])
        assert code_lines(diags) == expected(name)
        assert expected(name)  # the file is dirty

    def test_inplace_codes(self, corpus):
        diags = analyze_file(corpus["inplace_pin.py"])
        assert {d.code for d in diags} == {"RPR001", "RPR002"}
        assert any("lands on the copy" in d.message for d in diags)
        assert any("holds the new state" in d.message for d in diags)

    def test_backend_drift_names_the_misspelled_port_backend(self, corpus):
        diags = analyze_file(corpus["backend_drift.py"])
        assert any("'cuda_lena'" in d.message for d in diags)
        assert all("BACKENDS" in d.message for d in diags)

    def test_reference_noqa_does_not_silence_the_port(self, corpus):
        src = _source("backend_drift.py")
        line = next(i for i, t in enumerate(src.splitlines(), 1) if "# repro:" in t)
        assert ("RPR005", line) in code_lines(analyze_file(corpus["backend_drift.py"]))

    def test_port_noqa_does_not_silence_the_reference(self, tmp_path):
        from repro.analysis import analyze_file as ref_analyze_file

        p = tmp_path / "ref_drift.py"
        p.write_text(
            "def pick(backend):\n"
            f"    return backend == \"palas\"  {PORT_NOQA('RPR005', 'the port comment')}\n"
        )
        assert code_lines(ref_analyze_file(str(p))) == [("RPR005", 2)]
        # ... and the same line under the port's own comment is silenced here.
        assert analyze_file(str(p)) == []

    def test_objective_drift_names_the_vocabulary(self, corpus):
        diags = analyze_file(corpus["objective_drift.py"])
        assert diags and all("schedule.OBJECTIVES" in d.message for d in diags)

    def test_fault_point_checks_off_without_vocabulary(self, corpus):
        with open(corpus["fault_point_drift.py"], encoding="utf-8") as f:
            src = f.read()
        assert ast_checks.run_ast_checks(
            corpus["fault_point_drift.py"], src, analysis_cli.build_vocabulary(),
            objectives=analysis_cli.build_objectives(), fault_points=None,
        ) == []

    def test_objective_checks_off_without_vocabulary(self, corpus):
        with open(corpus["objective_drift.py"], encoding="utf-8") as f:
            src = f.read()
        assert ast_checks.run_ast_checks(
            corpus["objective_drift.py"], src, analysis_cli.build_vocabulary(), objectives=None
        ) == []

    def test_clean_file_is_clean(self, corpus):
        assert analyze_file(corpus["clean.py"]) == []

    def test_blessed_modules_are_the_ports_context_holders(self):
        for rel in ast_checks.BLESSED_CONTEXTVAR_MODULES:
            assert os.path.isfile(os.path.join(REPO_ROOT, "src", "repro_torch", rel)), rel


# ---------------------------------------------------------------------------
# Config/artifact contracts
# ---------------------------------------------------------------------------


class TestConfigContracts:
    def test_good_cache_is_clean(self, tmp_path):
        assert configcheck.check_tuning_cache_file(_cache(tmp_path, GOOD_ENTRIES)) == []

    def test_oversized_block_class(self, tmp_path):
        entries = {"h100/bfloat16/512x64x512": {
            "bm": 128, "bk": 128, "bn": 128, "backend": "cuda", "shape": [512, 64, 512]}}
        (d,) = configcheck.check_tuning_cache_file(_cache(tmp_path, entries))
        assert d.code == "RPR201" and "oversized-block" in d.message and "bk=128" in d.message

    def test_non_compiled_tile(self, tmp_path):
        entries = {"h100/bfloat16/512x512x512": {
            "bm": 96, "bk": 128, "bn": 128, "backend": "cuda", "shape": [512, 512, 512]}}
        (d,) = configcheck.check_tuning_cache_file(_cache(tmp_path, entries))
        assert d.code == "RPR201" and "compiled tile" in d.message

    def test_shared_memory_under_the_consumers_stage_model(self, tmp_path):
        # 128 x 256 x 256: one stage (196,624 B) fits h100's budget, the
        # pipelined kernel's shortest ring (2 stages, 393,248 B) does not.
        blk = {"bm": 128, "bk": 256, "bn": 256, "shape": [1024, 1024, 1024]}
        lean = {"h100/bfloat16/1024x1024x1024": dict(blk, backend="cuda_lean")}  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
        piped = {"h100/bfloat16/1024x1024x1024": dict(blk, backend="cuda")}  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
        assert configcheck.check_tuning_cache_file(_cache(tmp_path, lean, "lean.json")) == []
        (d,) = configcheck.check_tuning_cache_file(_cache(tmp_path, piped, "piped.json"))
        assert d.code == "RPR201" and "393248 B" in d.message and "2-stage" in d.message

    def test_key_drift_and_unknown_spec(self, tmp_path):
        entries = {
            "h100/bfloat16/512x512x512": {"bm": 64, "bk": 64, "bn": 64, "shape": [1024, 512, 512]},
            "tpu-v5e/bfloat16/512x512x512": {"bm": 128, "bk": 128, "bn": 128},
        }
        msgs = [d.message for d in configcheck.check_tuning_cache_file(_cache(tmp_path, entries))]
        assert len(msgs) == 2
        assert any("drifted apart" in m for m in msgs)
        assert any("unknown class spec 'tpu-v5e'" in m for m in msgs)

    def test_other_version_and_non_cache_ignored(self, tmp_path):
        bad = {"h100/bfloat16/512x512x512": {"bm": 96, "bk": 1, "bn": 1}}
        assert configcheck.check_tuning_cache_file(_cache(tmp_path, bad, version=99)) == []
        p = tmp_path / "other.json"
        p.write_text(json.dumps({"meta": {}, "records": []}))
        assert configcheck.check_tuning_cache_file(str(p)) == []

    def test_shared_bk_violation(self, monkeypatch):
        from repro_torch.core import blocking as B
        from repro_torch.core.control_tree import ControlTree

        def trees(shapes=None, backends=None):
            mk = lambda name, spec, bk: ControlTree(  # noqa: E731
                device_class=name, block=B.BlockConfig(64, bk, 64), coarse_loop="rows",
                spec=spec, problem_shape=(1024, 1024, 1024))
            yield (1024, 1024, 1024), "matmul", "rows", {
                "h100": mk("h100", B.H100, 128), "h100-little": mk("h100-little", B.H100_LITTLE, 64)}

        monkeypatch.setattr(configcheck, "shipped_trees", trees)
        (d,) = configcheck.check_shipped_trees()
        assert d.code == "RPR201" and "shared-B-panel" in d.message and "[64, 128]" in d.message

    def test_shipped_trees_visit_both_classes_and_loops(self):
        seen = {(shape, backend, loop, tuple(sorted(trees)))
                for shape, backend, loop, trees in configcheck.shipped_trees()}
        assert len(seen) == 3 * 2 * 2
        assert all(names == ("h100", "h100-little") for *_, names in seen)

    def test_bench_artifact_schema(self, tmp_path):
        p = tmp_path / "BENCH_malformed.json"
        p.write_text(json.dumps({"meta": {"git_sha": "deadbeef"}, "records": {"not": "a list"}}))
        diags = configcheck.check_bench_artifact(str(p))
        assert {d.code for d in diags} == {"RPR202"}
        msgs = " ".join(d.message for d in diags)
        assert "jax_version" in msgs and "records" in msgs
        assert {d.code for d in configcheck.check_artifacts_dir(str(tmp_path))} == {"RPR202"}


# ---------------------------------------------------------------------------
# CLI behaviour
# ---------------------------------------------------------------------------


class TestCli:
    def test_corpus_run_reports_every_code(self, corpus, tmp_path, capsys):
        bad = {"h100/bfloat16/512x64x512": {"bm": 128, "bk": 128, "bn": 128, "shape": [512, 64, 512]}}
        _cache(tmp_path, bad, "oversized_cache.json")
        rc = analysis_cli.main([str(tmp_path), "--no-contracts", "--format", "json"])
        assert rc == 1
        codes = {d["code"] for d in json.loads(capsys.readouterr().out)["diagnostics"]}
        assert codes == {"RPR000", "RPR001", "RPR002", "RPR003", "RPR004", "RPR005",
                         "RPR006", "RPR201"}

    def test_clean_file_exits_zero(self, corpus, capsys):
        assert analysis_cli.main([corpus["clean.py"], "--no-contracts"]) == 0
        capsys.readouterr()

    def test_missing_path_exits_two(self, capsys):
        assert analysis_cli.main(["no/such/path"]) == 2
        capsys.readouterr()

    def test_fixture_dirs_pruned_from_discovery(self, tmp_path, corpus):
        fx = tmp_path / "sub" / "fixtures"
        fx.mkdir(parents=True)
        (fx / "dirty.py").write_text(_source("compiled_in_loop.py"))
        py, _ = analysis_cli.discover([str(tmp_path)])
        assert py and all(os.sep + "fixtures" + os.sep not in p for p in py)
        # ... but analyzed when named explicitly.
        assert analysis_cli.analyze_paths([str(fx)], contracts=False)

    def test_default_paths_are_the_ports_files(self, monkeypatch):
        monkeypatch.chdir(REPO_ROOT)
        paths = analysis_cli.default_paths()
        assert os.path.join(".", "src", "repro_torch") in paths
        assert os.path.join(".", "chip_smoke.py") in paths
        tests = [p for p in paths if os.sep + "tests" + os.sep in p]
        assert tests and all(os.path.basename(p).startswith("test_torch_") for p in tests)

    def test_port_tree_is_clean(self, capsys, monkeypatch):
        # The acceptance gate: the port's analyzer over the port's files,
        # contract checks on, ends clean.
        monkeypatch.chdir(REPO_ROOT)
        rc = analysis_cli.main([])
        out = capsys.readouterr()
        assert rc == 0, out.out

    def test_reference_tree_is_not_the_ports_vocabulary(self, monkeypatch):
        # Over the reference's package the port's analyzer rightly flags
        # the reference's backend names.
        monkeypatch.chdir(REPO_ROOT)
        diags = analysis_cli.analyze_paths([os.path.join("src", "repro", "core")],
                                           contracts=False)
        assert any(d.code == "RPR005" and "'xla'" in d.message for d in diags)

    def test_list_codes_matches_the_reference_catalogue(self, capsys):
        from repro.analysis import CODES as REF_CODES

        assert analysis_cli.main(["--list-codes"]) == 0
        assert set(json.loads(capsys.readouterr().out)) == set(REF_CODES) == set(CODES)


# ---------------------------------------------------------------------------
# Diagnostic model / output formats
# ---------------------------------------------------------------------------


class TestDiagnostics:
    def test_unknown_code_rejected(self):
        with pytest.raises(ValueError, match="unknown diagnostic code"):
            Diagnostic(code="RPR999", path="x.py", line=1, message="nope")

    def test_github_format_is_annotation(self):
        d = Diagnostic(code="RPR001", path="a.py", line=3, message="m", col=7)
        assert format_github([d]).startswith("::error file=a.py,line=3,col=7,title=RPR001::")

    def test_json_format_round_trips(self):
        d = Diagnostic(code="RPR005", path="a.py", line=2, message="m")
        payload = json.loads(format_json([d]))
        assert payload["diagnostics"][0]["code"] == "RPR005"
        assert payload["codes"] == CODES

    def test_render_sorts_and_rejects_unknown_format(self):
        d1 = Diagnostic(code="RPR003", path="b.py", line=9, message="m")
        d2 = Diagnostic(code="RPR003", path="a.py", line=1, message="m")
        assert render([d1, d2], "text").splitlines()[0].startswith("a.py:1")
        with pytest.raises(ValueError, match="unknown format"):
            render([], "sarif")

    def test_each_analyzer_reads_only_its_own_suppressions(self):
        from repro.analysis.diagnostics import Suppressions as RefSuppressions
        from repro_torch.analysis.diagnostics import Suppressions

        src = (f"a = 1  {PORT_NOQA('RPR005', 'port')}\n"
               f"b = 2  {REF_NOQA('RPR005', 'reference')}\n")
        assert Suppressions.scan(src).by_line == {1: frozenset({"RPR005"})}
        assert RefSuppressions.scan(src).by_line == {2: frozenset({"RPR005"})}
