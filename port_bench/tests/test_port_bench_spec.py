"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"] and bench["command"][1].startswith("port_bench/")
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_bounds(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_cells(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", ["amass_leg3_int8.b256", "amass_leg3_f32.b64"])
def test_cell_files_found_by_name(bench, workload):
    cell = spec.cell(workload, bench)
    assert cell["config"]["driver"] == "recon" and spec.driver(cell["config"]).run
    assert cell["traffic"]["batch_size"] in (64, 256)
    assert set(cell["limits"]) == {"start_gap", "link_gap", "step_gap"}
    for m in cell["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    assert {m["name"] for m in cell["end_to_end"]} == {"recon_clips_per_s", "setup_s"}


def test_config_files_keep_published_widths(bench):
    for c in bench["configs"]:
        cfg = json.load(open(spec.ROOT / c["file"]))
        assert c["reduced"] == []
        assert cfg["trajnet"]["mid_dim"] == 512 and cfg["posenet"]["latent_dim"] == 512
        assert cfg["posenet"]["ff_size"] == 1024 and cfg["posenet"]["num_layers"] == 8
        assert cfg["diffusion_steps_posenet"] == 1000 and cfg["diffusion_steps_trajnet"] == 100
        assert cfg["body"] == {"num_verts": 10475, "num_joints": 55}
