"""The benchmark's files hold together: every cell, configuration, traffic
mix, driver and metric named in BENCHMARK.json has its file, found by name,
and the file keeps to the benchmark's contract."""

import importlib
import json
import re

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree(cell):
    bench, entry, cfile, cfg, traffic = run.cell_files(cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for k in ("config", "traffic", "chips", "why"):
        assert cfile[k] == entry[k], k
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]
    assert cfg["name"] == entry["config"]
    drv = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    assert callable(drv.Cell)
    assert traffic and cfile["limits"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("portbench/configs/")
    data = run.load_json(run.ROOT / config["file"])
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert sorted(data["reduced"]) == sorted(config["reduced"])
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank")) and key not in (
            "hidden_size", "intermediate_size", "head_dim", "num_experts_per_tok")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_names_units_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    for n in names + CELLS + [c["name"] for c in BENCH["configs"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_has_reader_and_its_cells_report_what_it_moves(metric):
    assert callable(run.reader(metric["name"]))
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert metric["moves"] in {m["name"] for m in run.end_to_end_metrics(BENCH, cell)}
        assert metric in run.per_layer_metrics(BENCH, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in run.end_to_end_metrics(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.per_layer_metrics(BENCH, cell)


def test_files_are_named_from_name_characters():
    for path in run.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or ".cache" in path.parts:
            continue
        rel = path.relative_to(run.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
