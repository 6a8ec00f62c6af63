"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a new configuration, mix and metric by their files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
BENCH = manifest.load()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_keys(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) - {"workloads"} == keys, e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)


def test_metric_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_cells_use_their_files():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert manifest.config(c["name"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        mix = manifest.mix(w["traffic"])
        assert os.path.exists(os.path.join(manifest.HERE, "drivers",
                                           mix["entry"] + ".py"))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        own = {m["name"] for m in manifest.end_to_end(BENCH, w["name"])}
        assert "setup_s" in own and len(own) >= 2
        assert manifest.per_layer(BENCH, w["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  manifest.end_to_end(BENCH, cell)}
        assert os.path.exists(os.path.join(manifest.HERE, "metrics",
                                           m["name"] + ".py"))


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    with open(os.path.join(manifest.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in layers:
        assert f"`{layer}`" in perf or layer in perf, layer


#: a driver of a new entry point, as a later PR would add it
DUMMY_DRIVER = """
def setup(ctx):
    return {}


def window(ctx, st):
    ctx.window_s = ctx.seconds
    return {"attempted": 1, "failed": 0, "metrics": {"dummy_per_s": 1.0}}


def check(ctx, st):
    return {"gap": (0.0, ctx.mix["limits"]["gap"])}


def readings(make, seeds, control_seeds):
    for seed in seeds:
        yield "program", seed, {"gap": 0.0}
        if seed in control_seeds:
            yield "control", seed, {"gap": 1.0}
"""


def test_new_cell_by_files_alone(tmp_path):
    """A configuration, two mixes (one with a new entry point and its
    driver), an end-to-end metric and a per-layer metric added as new
    files and new entries run, and calibrate, without an edit to any file
    there."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = manifest.config("deepblast-nw-layer")
    cfg["name"] = "dummy-layer"
    (root / "portbench/configs/dummy-layer.json").write_text(json.dumps(cfg))
    mix = manifest.mix("train-800")
    mix["potentials"].update(batch=2, n=12, m=10)
    mix["check_block"], mix["check_pairs"] = 2, 1
    (root / "portbench/traffic/dummy-mix.json").write_text(json.dumps(mix))
    (root / "portbench/traffic/dummy-entry-mix.json").write_text(json.dumps(
        {"entry": "dummy_entry", "limits": {"gap": 0.5}}))
    (root / "portbench/drivers/dummy_entry.py").write_text(DUMMY_DRIVER)
    (root / "portbench/metrics/dummy_steps.py").write_text(
        "def read(ctx):\n    return ctx.window_s and 1.0\n")
    bench["configs"].append({"name": "dummy-layer", "source": "x",
                             "file": "portbench/configs/dummy-layer.json",
                             "reduced": [], "why": "x"})
    bench["workloads"] += [
        {"name": "dummy.cell", "config": "dummy-layer",
         "traffic": "dummy-mix", "chips": 1, "why": "x"},
        {"name": "dummy.entry", "config": "dummy-layer",
         "traffic": "dummy-entry-mix", "chips": 1, "why": "x"}]
    layer = next(m for m in bench["end_to_end"]
                 if m["name"] == "layer_pairs_per_s")
    layer["workloads"].append("dummy.cell")
    bench["end_to_end"].append({"name": "dummy_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["dummy.entry"]})
    bench["per_layer"].append({"name": "dummy_steps", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "layer_pairs_per_s",
                               "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, {root!r}); "
            "sys.path.insert(1, {repo!r}); "
            "from portbench import calibrate, manifest, run; "
            "assert manifest.HERE.startswith({root!r}); "
            "r = [run.run_cell(c, 5, 0.2, t, 'cpu', "
            "bench=manifest.load({root!r})) for c in ('dummy.cell', "
            "'dummy.entry') for t in (0, 1)]; "
            "r.append(list(calibrate.readings('dummy.entry', [1], {{2}}, "
            "device='cpu'))); "
            "print(json.dumps(r))").format(root=str(root), repo=manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced, entry, _, cal = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and set(plain["metrics"]) == {
        "layer_pairs_per_s", "setup_s"}
    assert traced["metrics"]["dummy_steps"]["value"] == 1.0
    assert entry["correct"] and set(entry["metrics"]) == {
        "dummy_per_s", "setup_s"}
    assert [k for k, _, _ in cal] == ["program", "program", "control"]
