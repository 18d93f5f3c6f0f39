"""A cell as the files describe it: its entry in ``BENCHMARK.json``, its
workload file, its configuration file and its traffic file, each found by
name; the configuration's family module by the file's ``family``."""

from __future__ import annotations

import dataclasses
import json
import os

from portbench import families

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _load(root, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    conf: dict           # configs/<config>.json: the configuration as it is run
    traffic: dict        # traffic/<traffic>.json
    workload: dict       # workloads/<cell>.json: what the comparison holds it to
    port_cfg: object = None   # the program's ArchConfig of the same model

    @property
    def vocab(self) -> int:
        """The published vocabulary, the range of every token id and label:
        no padding row the family holds (``held_vocab``) is ever drawn."""
        return self.conf["vocab_size"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    man = manifest(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    return Cell(
        name=name,
        entry=entry,
        conf=_load(HERE, "configs", entry["config"] + ".json"),
        traffic=_load(HERE, "traffic", entry["traffic"] + ".json"),
        workload=_load(HERE, "workloads", name + ".json"),
    )


def check_port_config(conf: dict, cfg) -> None:
    """Raise unless the program's config ``cfg`` has the file's family and
    sizes (the family module's ``port_widths``)."""

    bad = [] if cfg.family == conf["family"] else [("family", conf["family"], cfg.family)]
    bad += [p for p in families.load(conf["family"]).port_widths(conf, cfg) if p[1] != p[2]]
    if bad:
        raise SystemExit(f"the program's {cfg.name} differs from the configuration file: "
                         + ", ".join(f"{k} file {a} program {b}" for k, a, b in bad))
