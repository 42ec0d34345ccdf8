"""BENCHMARK.json against its format (names, units, keys, limits), and every
cell's files found by name."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(MANIFEST["command"]) <= 32
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(group):
    entries = MANIFEST[group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if group == "configs":
            assert set(e) <= {"name", "source", "file", "reduced", "why"}
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
        if group == "workloads":
            assert set(e) == {"name", "config", "traffic", "chips", "why"}
            assert e["chips"] in (1, 4) and NAME.match(e["traffic"])
        if group == "end_to_end":
            assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if group == "per_layer":
            assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            moved = next(m for m in MANIFEST["end_to_end"] if m["name"] == e["moves"])
            for w in e.get("workloads", []):
                assert w in moved.get("workloads", [w])


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    for w in MANIFEST["workloads"]:
        cell = harness.load_cell(w["name"], MANIFEST)
        e2e = [m["name"] for m in harness.metrics_of(cell, MANIFEST, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(cell, MANIFEST, True)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell, MANIFEST)
    assert c.config["name"] == c.entry["config"]
    assert (harness.HERE / "paths" / f"{c.workload['path']}.py").exists()
    assert c.limits, f"limits/{cell}.json holds the cell's limits"
    for m in harness.metrics_of(c, MANIFEST, False) + harness.metrics_of(c, MANIFEST, True):
        assert callable(harness.reader(m["name"]))


def test_config_files_are_their_own():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark given a new traffic mix, limits, metric
    reader and manifest entries, and no edited file, runs its lookups."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    (tmp_path / "portbench" / "traffic" / "reconstruct-b2.json").write_text(json.dumps(
        dict(json.loads((harness.HERE / "traffic" / "reconstruct-b8.json").read_text()),
             batch=2)))
    (tmp_path / "portbench" / "limits" / "skirt-reconstruct-b2.json").write_text('{"x": 1}')
    (tmp_path / "portbench" / "metrics" / "frames_per_call.py").write_text(
        "def read(ctx, name):\n    return float(ctx.frames)\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "skirt-reconstruct-b2", "config": "garment4d-skirt",
                                  "traffic": "reconstruct-b2", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "frames_per_call", "unit": "frames", "better":
                                  "higher", "source": "host_clock", "layer": "test",
                                  "moves": "reconstruct_frames_per_s",
                                  "workloads": ["skirt-reconstruct-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copytree(ROOT / "ckpt_synth", tmp_path / "ckpt_synth")
    code = ("from portbench import harness\n"
            "c = harness.load_cell('skirt-reconstruct-b2')\n"
            "ms = [m['name'] for m in harness.metrics_of(c, harness.load_json("
            "harness.ROOT / 'BENCHMARK.json'), True)]\n"
            "assert c.workload['batch'] == 2 and c.limits == {'x': 1}, c.workload\n"
            "assert 'frames_per_call' in ms, ms\n"
            "assert harness.reader('frames_per_call') is not None\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_a_directory_of_the_benchmark_alone_refuses_to_run(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "skirt-reconstruct", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
