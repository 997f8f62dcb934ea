"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its files, each found by name and none edited to add another:

- ``configs/<config>.json``: the model, its architecture, its widths, its
  precision, its weights and the program settings that serve it (the file
  that ``BENCHMARK.json``'s ``configs`` entry names);
- ``arch/<architecture>.py`` and ``reference/<architecture>.py``: the
  architecture that the configuration's ``architecture`` names: its
  published widths, plain reference, counts and controls
  (``arch/__init__.py``);
- ``traffic/<traffic>.json``: the generator's parameters (``gen.py``);
- ``workloads/<cell>.json``: the cell's own program settings and the limits
  that decide ``correct``;
- ``metrics/<name>.py``: the reader of each per-layer metric that lists the
  cell, or lists no cells.
"""
from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCH = "amc_bench.arch"
# Keys every configuration states besides its architecture, of any architecture.
REQUIRED = ("frame_len", "num_classes", "precision", "weights")


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def architectures() -> list[str]:
    """The architectures that have a module under ``arch/``."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "arch"))
                  if f.endswith(".py") and f != "__init__.py")


def architecture(config: dict):
    """The module of the architecture that ``config`` names,
    ``amc_bench.arch.<architecture>``; KeyError when it names none or one
    with no module."""
    name = config.get("architecture")
    if isinstance(name, str) and name.isidentifier():
        try:
            return importlib.import_module(f"{ARCH}.{name}")
        except ModuleNotFoundError as exc:
            if exc.name != f"{ARCH}.{name}":
                raise
    raise KeyError(f"configuration {config.get('name')!r} names architecture {name!r}, "
                   f"which has no module in amc_bench/arch/; known: {', '.join(architectures())}")


def load_config(path: str) -> dict:
    """The configuration file at ``path``, checked: its architecture found
    and every key of ``REQUIRED`` stated."""
    cfg = _json(path)
    architecture(cfg)
    missing = [k for k in REQUIRED if k not in cfg]
    if missing:
        raise KeyError(f"{path} states no {', '.join(missing)}; every configuration "
                       f"states architecture, {', '.join(REQUIRED)}")
    return cfg


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    settings: dict        # workloads/<cell>.json
    end_to_end: list      # BENCHMARK.json's end_to_end entries the cell reports
    per_layer: list       # BENCHMARK.json's per_layer entries the cell reports

    def overrides(self) -> list[str]:
        """The program's ``key=value`` settings: the configuration's, then
        the cell's."""
        return list(self.config.get("program", [])) + list(self.settings.get("program", []))

    def path(self, rel: str) -> str:
        """A path the configuration names, relative to the checkout's root."""
        return os.path.join(ROOT, rel)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError when there is none."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {', '.join(sorted(cells))}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=w["chips"],
        config=load_config(os.path.join(ROOT, cfg_entry["file"])),
        traffic=_json(HERE, "traffic", w["traffic"] + ".json"),
        settings=_json(HERE, "workloads", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    import importlib.util

    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "amc_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
