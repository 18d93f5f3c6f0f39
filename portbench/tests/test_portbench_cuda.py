"""On the card, at the cells' own sizes: the control (the reference with
fp8 operands in the program's place) comes out not correct, and a sound
program's readings within the limits.  Run on a machine with a card:
``python -m pytest -q -m cuda portbench/tests/test_portbench_cuda.py``."""

import pytest

from portbench import run as RUN

CELLS = ["internlm2-1.8b.train", "internlm2-1.8b.score", "internlm2-1.8b.train_mixed"]
SECONDS = {"train": 0.0, "score": 5.0}     # a scoring window answers a whole deck


def _cell(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    RUN.prepare_environment()
    from portbench.cell import check_port_config, load_cell
    from repro_torch.configs import get_config

    cell = load_cell(name)
    cell.port_cfg = get_config(cell.conf["port_arch"])
    check_port_config(cell.conf, cell.port_cfg)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = _cell(name)
    res = RUN.run_cell(cell, 2**31 + 77, SECONDS[cell.traffic["kind"]], False, "cuda",
                       control=True)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    cell = _cell(name)
    res = RUN.run_cell(cell, 2**31 + 78, SECONDS[cell.traffic["kind"]], False, "cuda")
    assert res["correct"] is True, res["checks"]
