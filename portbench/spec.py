"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics. Each piece is a file of its own, found by its name:

  - a configuration: the ``file`` of its entry (``portbench/configs/<name>.json``);
  - a traffic mix: ``portbench/traffic/<name>.json``, data that names its
    generator, ``portbench/generators/<generator>.py`` (``generate.py``);
  - a per-layer metric: ``portbench/metrics/<name>.py``, whose ``read(ctx)``
    returns the value or None when it finds nothing to read;
  - a family's plain reference: ``portbench/reference/<family>.py``;
  - a configuration's limits for ``correct``: ``portbench/limits/<name>.json``.

A later change adds files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    conf = json.loads((Path(root) / entry["file"]).read_text())
    conf["name"] = name
    return conf


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "portbench" / "traffic" / f"{name}.json").read_text())


def limits(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "portbench" / "limits" / f"{name}.json").read_text())


def load_file(path: Path, name: str):
    """The module in ``path``: a metric's file is named after the metric,
    dots and all, so it is loaded by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(family: str, root: Path = ROOT):
    return load_file(Path(root) / "portbench" / "reference" / f"{family}.py",
                     f"portbench_reference_{family}")


def generator(name: str, root: Path = ROOT):
    return load_file(Path(root) / "portbench" / "generators" / f"{name}.py",
                     "portbench_generator_" + name.replace(".", "_").replace("-", "_"))


def metric(name: str, root: Path = ROOT):
    return load_file(Path(root) / "portbench" / "metrics" / f"{name}.py",
                     "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
