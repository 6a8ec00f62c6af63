"""``BENCHMARK.json`` and the files it names, found by name: a
configuration in ``configs/<config>.json``, a traffic mix in
``traffic/<mix>.json`` whose ``entry`` names a driver
``drivers/<entry>.py``, a per-layer metric's reader in
``metrics/<metric>.py``.  Nothing is registered anywhere else, so a new
configuration, mix or metric is a new file and a new entry."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

__all__ = ["HERE", "ROOT", "load", "workload", "config", "mix",
           "end_to_end", "per_layer", "load_module"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name, here=HERE):
    with open(os.path.join(here, "configs", f"{name}.json")) as f:
        return json.load(f)


def mix(name, here=HERE):
    with open(os.path.join(here, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _reports(metric, cell):
    return cell in metric["workloads"] if "workloads" in metric else True


def end_to_end(bench, cell):
    """The end-to-end metrics that cell ``cell`` reports."""
    return [m for m in bench["end_to_end"] if _reports(m, cell)]


def per_layer(bench, cell):
    """The per-layer metrics that cell ``cell`` reports: those listing it,
    and those without a list whose moved metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def load_module(kind, name, here=HERE):
    """The module ``<here>/<kind>/<name>.py`` (a driver or a reader)."""
    path = os.path.join(here, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    if spec.name not in sys.modules:
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[spec.name]
