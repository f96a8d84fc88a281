"""``BENCHMARK.json`` and the files its names lead to.

A cell (a ``workloads`` entry) names a configuration and a traffic mix; the
configuration's ``file`` holds its scheme and names its plain reference, a
module under ``reference/``; the traffic is ``traffic/<traffic>.json``, and
each metric the cell reports is read by ``metrics/<metric>.py``.  Nothing
here imports the program.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
SPEC = REPO / "BENCHMARK.json"

#: a name of a cell, configuration, traffic mix, metric or reduced key
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    chips: int
    config: dict
    traffic: dict
    reference: ModuleType  # the configuration's plain reference
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load(path: Path = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not an allowed name: {name!r}")
    return name


def reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded by its path (a metric's name may hold
    dots)."""
    path = HERE / "metrics" / f"{check_name(name)}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    if mod_spec is None or not path.exists():
        raise ValueError(f"metric {name!r} has no reader at {path}")
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reference(config: dict) -> ModuleType:
    """The module that ``config["reference"]`` names by its path,
    ``benchmark/reference/<name>.py``."""
    path = config["reference"]
    parts = path.split("/")
    if len(parts) != 3 or parts[:2] != ["benchmark", "reference"] or not path.endswith(".py"):
        raise ValueError(f"a reference lies at benchmark/reference/<name>.py, not {path!r}")
    name = parts[2][:-3]
    if not (name.isascii() and name.isidentifier()) or not (HERE / "reference" / parts[2]).exists():
        raise ValueError(f"no reference module at {path!r}")
    return importlib.import_module(f"benchmark.reference.{name}")


def config_file(spec: dict, name: str) -> Path:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return REPO / entry["file"]
    raise ValueError(f"no configuration named {name!r}")


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{check_name(name)}.json"


def metrics_of(spec: dict, cell: str, kind: str) -> List[Metric]:
    """The metrics of ``kind`` that ``cell`` reports: those whose
    ``workloads`` list it, or that have no such list."""
    out = []
    for entry in spec[kind]:
        if cell in entry.get("workloads", [cell]):
            out.append(Metric(entry["name"], entry["unit"], reader(entry["name"])))
    return out


def workload(spec: dict, name: str) -> Workload:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            break
    else:
        raise ValueError(f"no workload named {name!r} in BENCHMARK.json")
    with open(config_file(spec, cell["config"])) as f:
        config = json.load(f)
    with open(traffic_file(cell["traffic"])) as f:
        traffic = json.load(f)
    return Workload(name, int(cell["chips"]), config, traffic, reference(config),
                    metrics_of(spec, name, "end_to_end"), metrics_of(spec, name, "per_layer"))
