"""A cell, a traffic mix, a per-layer metric and a configuration with a
reference module of its own, added as files (and entries), are found by
name, with no file of the harness edited."""

import json
import shutil

from benchmark import spec, traffic, weights


def test_added_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    monkeypatch.setattr(spec, "HERE", str(root))
    monkeypatch.setattr(traffic, "HERE", str(root))
    bench = spec.load()
    bench["workloads"].append({"name": "tfm-int8.npc-burst.engine", "config": "zonos-v0.1-transformer.int8",
                               "traffic": "npc-burst", "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "engine.new_metric", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "continuous engine", "moves": "ttfa_p90_ms",
                               "workloads": ["tfm-int8.npc-burst.engine"]})
    mix = dict(spec.traffic("npc-stream"), chars={"min": 20, "max": 30, "median": 25, "sigma": 0.1})
    (root / "traffic" / "npc-burst.json").write_text(json.dumps(mix))
    (root / "cells" / "tfm-int8.npc-burst.engine.json").write_text(json.dumps(
        dict(spec.cell("tfm-int8.npc-stream.engine"), rate_rps=2.0)))
    (root / "metrics" / "engine.new_metric.py").write_text("def read(ctx):\n    return 42.0\n")

    w = spec.workload(bench, "tfm-int8.npc-burst.engine")
    assert spec.traffic(w["traffic"])["chars"]["max"] == 30
    assert spec.cell(w["name"])["rate_rps"] == 2.0
    reqs = traffic.make_requests(spec.traffic(w["traffic"]), 3, 10, spec.cell(w["name"])["rate_rps"])
    assert len(reqs) == 20 and all(len(r.text) <= 30 for r in reqs)
    names = [m["name"] for m in spec.end_to_end(bench, w["name"])]
    assert "ttfa_p90_ms" not in names  # that metric lists its cells; this cell reports setup_s only
    layer = spec.per_layer(bench, w["name"], names + ["ttfa_p90_ms"])
    assert [m["name"] for m in layer] == ["engine.new_metric"]
    assert spec.reader("engine.new_metric")(None) == 42.0


def test_every_named_file_exists():
    bench = spec.load()
    for w in bench["workloads"]:
        spec.cell(w["name"])
        spec.traffic(w["traffic"])
        json.load(open(spec.config_path(bench, w["config"])))
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_configuration_with_its_own_reference_is_found(tmp_path, monkeypatch):
    root = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(spec, "HERE", str(root))
    (root / "reference" / "own_model.py").write_text(
        "from benchmark.reference.model import ZonosReference, weight_specs as zonos_specs\n\n\n"
        "class Reference(ZonosReference):\n    pass\n\n\n"
        "def weight_specs(cfg, phoneme_vocab):\n"
        "    return zonos_specs(cfg, phoneme_vocab) + [('extra.weight', (4,), ('const', 2.0))]\n")
    doc = dict(json.loads((root / "tests" / "tiny-transformer.json").read_text()), reference="own_model",
               path_key="PATH_MODEL_OWN")
    (root / "configs" / "own-model.json").write_text(json.dumps(doc))
    bench = spec.load()
    bench["configs"].append({"name": "own-model", "source": "https://example.org/own-model",
                             "file": "benchmark/configs/own-model.json", "reduced": [], "why": "a later model"})
    with open(spec.config_path(bench, "own-model", root=str(tmp_path))) as f:
        found = json.load(f)
    assert found["path_key"] == "PATH_MODEL_OWN"
    assert spec.reference(found).Reference.__name__ == "Reference"
    w = weights.make_weights(found, 3, "cpu")["zonos"]
    assert float(w["extra.weight"].sum()) == 8.0
    assert spec.reference({}).Reference.__name__ == "ZonosReference"
