"""Cells of the benchmark cut to the program's reduced configs, for CPU
tests: the same files, every width taken from ``ArchConfig.reduced()``
(the family module's ``reduced``) and the traffic shortened."""

from __future__ import annotations

from portbench import cell as C
from portbench import families


def reduced_cell(name: str):
    from repro_torch.configs import get_config

    cell = C.load_cell(name)
    cell.port_cfg = get_config(cell.conf["port_arch"]).reduced()
    cell.conf = families.load(cell.conf["family"]).reduced(cell.conf, cell.port_cfg)
    C.check_port_config(cell.conf, cell.port_cfg)
    if cell.traffic["kind"] == "train":
        cell.traffic = dict(cell.traffic, batch=4, seq=32)
    else:
        cell.traffic = dict(cell.traffic, length_min=16, length_max=64, length_multiple=8,
                            deck=8)
    return cell
