"""BENCHMARK.json against the benchmark's contract, and every file a cell
or a metric is found by."""

import json
import os
import re

import pytest

from portbench import cell as C
from portbench import run as RUN

MAN = C.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HERE = os.path.dirname(C.__file__)


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()), ids=lambda x: str(x)[:40])
def test_names_and_units(group, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_end_to_end_bounds():
    names = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in names and names["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(w):
    cell = C.load_cell(w["name"])
    assert w["chips"] in (1, 4)
    assert w["config"] in {c["name"] for c in MAN["configs"]}
    assert os.path.exists(os.path.join(HERE, "drivers", cell.traffic["kind"] + ".py"))
    e2e, layer = RUN.reported(MAN, w["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:   # each per-layer metric's `moves` is reported where it is
        assert m["moves"] in names


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_readers(m):
    assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
    assert callable(RUN.load_reader(m["name"]))
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in m.get("workloads", []):
        assert cell in {w["name"] for w in MAN["workloads"]}


FAMILY = ("n_layers", "d_model", "norm_eps", "tied_head", "held_vocab", "port_widths",
          "block_leaves", "layer", "layer_matmul_params", "mixer_flops", "funnel_products",
          "flash_bound_s", "reduced")


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_family_modules(c):
    from portbench import families

    with open(os.path.join(C.ROOT, c["file"])) as f:
        fam = families.load(json.load(f)["family"])
    assert all(callable(getattr(fam, k, None)) for k in FAMILY)


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("portbench/configs/")
    with open(os.path.join(C.ROOT, c["file"])) as f:
        conf = json.load(f)
    assert conf["reduced"] == c["reduced"]
    assert conf["source"].split(" ")[0] == c["source"]
    assert not any(k.endswith(("_dim", "_rank", "_size")) or k in ("expand", "d_state")
                   for k in c["reduced"])
    from repro_torch.configs import get_config

    C.check_port_config(conf, get_config(conf["port_arch"]))


def test_limits_name_the_compared_numbers():
    import importlib

    given = {"train": {"loss_gap", "grad_norm_gap", "first_grad_gap", "first_grad_diff_gap",
                       "change_gap", "decay_gap"},
             "score": {"logprob_gap_max", "logprob_gap_rms"}}
    for w in MAN["workloads"]:
        cell = C.load_cell(w["name"])
        importlib.import_module("portbench.drivers." + cell.traffic["kind"])
        assert cell.limits and set(cell.limits) <= given[cell.traffic["kind"]]
        assert all(v > 0 for v in cell.limits.values())
