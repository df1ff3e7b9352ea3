"""Finds a cell, its configuration, its traffic mix and its metrics by name.

* ``BENCHMARK.json`` at the checkout's root: which end-to-end and per-layer
  metrics each cell reports;
* ``portbench/workloads/<cell>.json``: the cell (configuration, traffic mix,
  chips, why, and the limits of its output check);
* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/traffic/<mix>.json``: the mix's parameters, read by the one
  fixture (``fixture.py``), the request generator the mix names
  (``portbench/generators/<name>.py``) and the driver it names
  (``portbench/drivers/<name>.py``);
* ``portbench/families/<family>.py``: how a configuration's family is built
  into the port and the reference, and its counted work;
* ``portbench/layouts/<layout>.py``: a family's fixture files on disk;
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader.

Every module is loaded from its file by name, so a later cell, mix, driver,
family or metric is one new file, and the core is not edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class ManifestError(ValueError):
    pass


def _load(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ManifestError(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise ManifestError(f"no {kind} file {path}")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise ManifestError(f"no {path}")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def workload(name: str) -> dict:
    return _load("workloads", name)


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_of(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, cell) and m["moves"] in moved]
    return e2e, layer


_MODULES: dict = {}


def module(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded from its file once
    a run. Its imports of the benchmark's own code are absolute
    (``from portbench import flops``)."""
    if not NAME.match(name):
        raise ManifestError(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise ManifestError(f"no {kind} file {path}")
    if path not in _MODULES:
        key = re.sub(r"[^A-Za-z0-9_]", "_", f"portbench_{kind}_{name}")
        spec = importlib.util.spec_from_file_location(key, path)
        loaded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded)
        _MODULES[path] = loaded
    return _MODULES[path]


def reader(name: str):
    """A per-layer metric's reader: ``portbench/metrics/<name>.py`` (its
    ``read(run)``)."""
    return module("metrics", name)


def driver(name: str):
    """A traffic mix's driver: ``portbench/drivers/<name>.py`` (its
    ``Driver(run)``)."""
    return module("drivers", name)


def generator(name: str):
    """A traffic mix's request generator: ``portbench/generators/<name>.py``
    (its ``rows(fixture)`` and ``requests(fixture)``)."""
    return module("generators", name)


def layout(name: str):
    """A family's fixture files: ``portbench/layouts/<name>.py`` (its
    ``write(fixture, rng)``)."""
    return module("layouts", name)


def family(name: str):
    """A model family: ``portbench/families/<name>.py``, how a configuration
    is built into the port and into the reference."""
    return module("families", name)
