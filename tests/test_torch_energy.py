"""Port vs reference: the energy objectives (load-adaptive pod parking, EDP).

The engine cases of ``tests/test_energy.py`` run against the port's
engine on the reduced internlm2 (4 layers, d 64; the reference's weights
carried over by ``convert.params_from_jax``): ``energy`` parks the big pod
at low load and spends fewer modeled joules with the same tokens, ``perf``
never parks, and load re-admits a parked pod.

The parity case builds a port mesh and a reference mesh with *identical*
power numbers, peak rates and ``rel_throughput`` (the port's Hopper
constants written into the reference's TPU specs) and drives both engines
through the same waves of requests: the efficiency order, every park and
un-park event (pod, decode step), every step's slot budgets and parked
set, and the placement of every request must be equal, and the modeled
joules equal to 1e-9 relative (both sum the same float terms in the same
order).  Parking never reads a token, so the framework's bf16 rounding
cannot move it.  The power numbers are modeled, not measured.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import blocking as JB
from repro.core.asymmetric import AsymmetricMesh as JMesh
from repro.core.asymmetric import DeviceClass as JClass
from repro.launch import serve as jax_serve
from repro.models import model_zoo as JZ
from repro.runtime.serving import ServingEngine as JaxEngine

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import blocking as B
from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass, biglittle_classes
from repro_torch.launch import serve
from repro_torch.runtime.serving import ServingEngine

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def small():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _biglittle(**kw):
    kw.setdefault("strategy", "ca-das")
    kw.setdefault("batch_tile", 1)
    return AsymmetricMesh(biglittle_classes(chips_per_pod=1), **kw)


def _engine(cfg, params, objective, slots_per_pod=4, **kw):
    return ServingEngine(cfg, params, _biglittle(objective=objective), seq_cap=32,
                         slots_per_pod=slots_per_pod, device="cpu", **kw)


def test_energy_parks_and_spends_fewer_joules(small):
    *_, cfg, params = small
    prompts = RNG.integers(0, cfg.vocab, (3, 4), dtype=np.int32)
    perf_eng = _engine(cfg, params, "perf")
    perf_out = perf_eng.generate(prompts, 6)
    en_eng = _engine(cfg, params, "energy")
    en_out = en_eng.generate(prompts, 6)
    # The objective changes placement and pacing, never the math.
    assert np.array_equal(perf_out, en_out)
    # At 3 in-flight requests the little pod alone covers the load (after
    # hysteresis), so the big pod parks under energy.
    assert perf_eng.stats.pod_parks == 0
    assert en_eng.stats.pod_parks >= 1
    assert en_eng.parked_pods == [0]
    assert all(c.pod == 1 for c in en_eng.completions)
    assert 0 < en_eng.stats.energy_j < perf_eng.stats.energy_j
    assert en_eng.stats.tokens_per_j > perf_eng.stats.tokens_per_j
    assert en_eng.stats.modeled_decode_s > 0


def test_perf_objective_never_parks(small):
    *_, cfg, params = small
    prompts = RNG.integers(0, cfg.vocab, (2, 4), dtype=np.int32)
    eng = _engine(cfg, params, "perf")
    eng.generate(prompts, 4)
    assert eng.parked_pods == []
    assert eng.stats.pod_parks == 0 and eng.stats.pod_unparks == 0


@pytest.mark.parametrize("objective", ["energy", "edp"])
def test_energy_readmits_under_load(small, objective):
    # Saturating the slot table forces the parked pod back in: parking is
    # load-adaptive, not a static cap.
    *_, cfg, params = small
    eng = _engine(cfg, params, objective, slots_per_pod=2)
    eng.generate(RNG.integers(0, cfg.vocab, (1, 4), dtype=np.int32), 3)
    assert eng.parked_pods == [0]
    out = eng.generate(RNG.integers(0, cfg.vocab, (4, 4), dtype=np.int32), 3)
    assert out.shape[0] == 4
    assert eng.stats.pod_unparks >= 1


# ---------------------------------------------------------------------------
# The same power numbers in both packages
# ---------------------------------------------------------------------------


def _pair(classes):
    """The reference's twins of the port's classes: the same name, pods,
    rates, ``rel_throughput`` and power numbers, on the reference's TPU
    spec otherwise (its block shapes never reach parking)."""

    return [JClass(name=c.name, n_pods=c.n_pods, chips_per_pod=c.chips_per_pod,
                   peak_flops=c.peak_flops, hbm_bw=c.hbm_bw, rel_throughput=c.rel_throughput,
                   spec=dataclasses.replace(JB.TPU_V5E, power=JB.PowerModel(
                       **dataclasses.asdict(c.spec.power)))) for c in classes]


def _with_power(classes, **power):
    return [dataclasses.replace(c, spec=dataclasses.replace(
        c.spec, power=dataclasses.replace(c.spec.power, **power))) for c in classes]


@pytest.mark.parametrize("gated_w", [0.0, 7.5])
def test_gated_watts_and_efficiency_order_match_reference(gated_w):
    classes = _with_power(biglittle_classes(chips_per_pod=2), gated_w=gated_w)
    port = AsymmetricMesh(classes, batch_tile=1, objective="energy")
    ref = JMesh(_pair(classes), batch_tile=1, objective="energy")
    assert port.pod_gated_watts() == ref.pod_gated_watts() == [2 * gated_w] * 2
    assert port.pod_active_watts() == ref.pod_active_watts()
    assert port.pods_by_efficiency() == ref.pods_by_efficiency() == [1, 0]
    # 160.65 W / 0.25 against 651.5 W / 1: little first, by 1.4%.
    watts = port.pod_active_watts()
    assert watts[1] / 0.25 < watts[0] < 1.02 * watts[1] / 0.25
    # A tie in watts per unit of throughput breaks by pod index.
    even = [DeviceClass(name=n, rel_throughput=r, spec=dataclasses.replace(
        B.H100, power=B.PowerModel(idle_w=w, flop_j=0.0))) for n, r, w in
        (("a", 1.0, 100.0), ("b", 0.5, 50.0), ("c", 0.5, 40.0))]
    port = AsymmetricMesh(even, batch_tile=1)
    assert port.pods_by_efficiency() == JMesh(_pair(even), batch_tile=1).pods_by_efficiency() \
        == [2, 0, 1]


def _instrument(eng):
    """Record park / un-park events as (kind, pod, decode step)."""

    events = []
    for name in ("_park", "_unpark"):
        real = getattr(eng, name)

        def hook(pod, n_work, real=real, name=name):
            events.append((name, int(pod), eng._step_calls))
            real(pod, n_work)

        setattr(eng, name, hook)
    return events


def _drive(eng, waves):
    """Serve each wave of requests to completion, as ``run`` does, with
    every step's budgets and parked pods on record."""

    steps = []
    for wave in waves:
        for prompt, n in wave:
            eng.submit(prompt, n)
        while True:
            if any(eng.queues):
                eng.admit()
            if not (eng.slot_rid >= 0).any():
                break
            eng.step()
            steps.append((list(eng.budgets), sorted(eng._parked)))
    return steps


@pytest.mark.parametrize("objective", ["energy", "edp"])
def test_parking_sequence_and_joules_equal_the_reference(small, objective):
    jcfg, jparams, cfg, params = small
    classes = biglittle_classes(chips_per_pod=1)
    rng = np.random.default_rng(11)
    waves = [[(rng.integers(0, cfg.vocab, 3, dtype=np.int32), 5) for _ in range(n)]
             for n in (2, 10, 1, 6)]
    port = ServingEngine(cfg, params, AsymmetricMesh(classes, batch_tile=1, objective=objective),
                         seq_cap=16, slots_per_pod=4, device="cpu")
    ref = JaxEngine(jcfg, jparams, JMesh(_pair(classes), batch_tile=1, objective=objective),
                    seq_cap=16, slots_per_pod=4, class_sharded="off")
    assert port.asym.pods_by_efficiency() == ref.asym.pods_by_efficiency()
    ev_port, ev_ref = _instrument(port), _instrument(ref)
    steps_port, steps_ref = _drive(port, waves), _drive(ref, waves)

    assert ev_port == ev_ref
    assert {k for k, *_ in ev_port} == {"_park", "_unpark"}  # both moves happened
    assert steps_port == steps_ref
    placed = lambda e: sorted((c.rid, c.slot, c.pod) for c in e.completions)  # noqa: E731
    assert placed(port) == placed(ref)
    for key in ("pod_parks", "pod_unparks", "decode_steps", "tokens", "admission_rounds"):
        assert getattr(port.stats, key) == getattr(ref.stats, key), key
    assert port.stats.energy_j == pytest.approx(ref.stats.energy_j, rel=1e-9, abs=0)
    assert port.stats.modeled_decode_s == pytest.approx(ref.stats.modeled_decode_s, rel=1e-9)


def test_engine_metrics_and_trace_record_parking(small):
    from repro_torch import observability as OBS

    *_, cfg, params = small
    OBS.enable()
    try:
        eng = _engine(cfg, params, "energy")
        eng.generate(RNG.integers(0, cfg.vocab, (2, 4), dtype=np.int32), 4)
        snap = OBS.REGISTRY.snapshot()
    finally:
        buf = OBS.disable()
    assert snap["engine_pods_parked"]["samples"][0]["value"] == 1
    assert snap["engine_modeled_watts"]["samples"][0]["value"] > 0
    names = {e.name for e in buf.events}
    assert "engine.pod_park" in names


def _summary(capsys, *argv):
    got = serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "3",
                      "--prompt-len", "4", "--gen-len", "6", "--slots-per-pod", "4", *argv])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    return got


def test_serve_cli_objective(monkeypatch, capsys):
    perf = _summary(capsys)
    energy = _summary(capsys, "--objective", "energy")
    assert perf["objective"] == "perf" and energy["objective"] == "energy"
    assert perf["engine"]["parked_pods"] == [] and perf["engine"]["pod_parks"] == 0
    assert energy["engine"]["parked_pods"] == [0] and energy["engine"]["pod_parks"] >= 1
    assert 0 < energy["engine"]["energy_j"] < perf["engine"]["energy_j"]
    assert energy["engine"]["tokens_per_j"] > perf["engine"]["tokens_per_j"]
    assert energy["sample"] == perf["sample"]
    with pytest.raises(SystemExit, match="engine path only"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--one-shot",
                    "--objective", "edp"])
    # The reference's summary under the same flags has no key the port lacks.
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--reduced", "--batch", "3",
                                     "--prompt-len", "4", "--gen-len", "6", "--slots-per-pod", "4",
                                     "--class-sharded", "off", "--objective", "energy"])
    jax_serve.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(energy) and set(want["engine"]) <= set(energy["engine"])
    assert want["objective"] == energy["objective"]
    assert want["engine"]["pod_parks"] == energy["engine"]["pod_parks"]
