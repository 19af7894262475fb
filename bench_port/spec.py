"""What a run reads: its cell from ``BENCHMARK.json``, the cell's
configuration and traffic mix, and the files found by name under this
folder (model families, traffic kinds, per-layer metric readers).

A later change adds a cell, a mix, a configuration, a model family or a
metric by adding files and entries only: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    family: ModuleType  # families/<config["family"]>.py


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(benchmark_path: Path, name: str) -> Cell:
    """The cell ``name`` of ``benchmark_path``, with its configuration
    and traffic files read and its metrics chosen."""
    bench = json.loads(Path(benchmark_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark_path}; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    root = Path(benchmark_path).resolve().parent
    config = json.loads((root / entry["file"]).read_text())
    return Cell(
        name=name,
        config_name=cell["config"],
        config=config,
        traffic_name=cell["traffic"],
        traffic=load_traffic(cell["traffic"]),
        chips=int(cell["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        family=family_of(config, entry["file"]),
    )


def load_traffic(name: str, folder: Path = HERE / "traffic") -> Dict[str, Any]:
    return json.loads((folder / f"{name}.json").read_text())


def _module(path: Path) -> ModuleType:
    name = re.sub(r"\W", "_", f"bench_port_{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # where a dataclass of the file looks its module up
    spec.loader.exec_module(module)
    return module


def family(name: str, folder: Path = HERE / "families") -> ModuleType:
    """Everything the harness knows about a model's block:
    ``families/<name>.py``, whose contract ``families/__init__.py`` gives."""
    return _module(folder / f"{name}.py")


def family_of(config: Dict[str, Any], where: str = "the configuration",
              folder: Path = HERE / "families") -> ModuleType:
    """The family a configuration names under ``"family"``; refuses one
    that names none, or one with no file in ``folder``."""
    found = sorted(p.stem for p in folder.glob("*.py") if p.stem != "__init__")
    name = config.get("family")
    if name not in found:
        raise ValueError(f'{where} must name its model family under the key "family" '
                         f"(it has {name!r}); families found: {', '.join(found) or 'none'}")
    return family(name, folder)


def traffic_kind(kind: str, folder: Path = HERE / "traffic" / "kinds") -> ModuleType:
    """The generator of a traffic kind: ``traffic/kinds/<kind>.py``."""
    return _module(folder / f"{kind}.py")


def metric_reader(name: str, folder: Path = HERE / "metrics") -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<name>.py``, whose
    ``read(record)`` returns the value or None where it finds nothing.
    A name with a suffix, ``<base>.<suffix>``, is one quantity reported
    beside another end-to-end metric: it is read by ``metrics/<base>.py``
    where it has no file of its own."""
    path = folder / f"{name}.py"
    if not path.exists():
        path = folder / f"{name.split('.')[0]}.py"
    return _module(path)
