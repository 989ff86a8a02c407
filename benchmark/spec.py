"""``BENCHMARK.json`` and the files it names, found by name.

A workload's configuration file is the ``file`` of its ``configs`` entry; its
traffic mix is ``benchmark/traffic/<traffic>.json``; its cell file (rate,
server mode, comparison limits) is ``benchmark/cells/<workload>.json``; a
per-layer metric's reader is ``benchmark/metrics/<metric name>.py``; a
configuration's reference model is ``benchmark/reference/<reference>.py``
(its file's ``reference`` key, ``model`` where it names none). A later
change adds a cell, a mix, a metric or a model by adding such files and
entries.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def load(root: str = REPO) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_path(bench: dict, name: str, root: str = REPO) -> str:
    for c in bench["configs"]:
        if c["name"] == name:
            return os.path.join(root, c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def cell(name: str) -> dict:
    return _json("cells", f"{name}.json")


def per_layer(bench: dict, workload_name: str, end_to_end: list[str]) -> list[dict]:
    """The per-layer metrics this workload reports: those listing it, and
    those without a list whose end-to-end metric it reports."""
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in end_to_end:
            out.append(m)
    return out


def end_to_end(bench: dict, workload_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or workload_name in m["workloads"]]


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(doc: dict):
    """The reference module that a configuration's contents name: its float32
    model class ``Reference`` and its ``weight_specs(cfg, phoneme_vocab)``."""
    return _module("reference", doc.get("reference", "model"))


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<metric_name>.py``."""
    return _module("metrics", metric_name).read
