"""BENCHMARK.json against the rules of its format: names, units and
lengths, each per-layer metric's ``moves`` reported by each of its cells,
a cell for every configuration, and every file the manifest names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = {w["name"]: w for w in MAN["workloads"]}


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN).encode()) <= 64 * 1024
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["command"]) <= 32
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()


def test_names_units_and_texts():
    names = ([c["name"] for c in MAN["configs"]] + list(CELLS)
             + [m["name"] for m in METRICS])
    names += [w["config"] for w in CELLS.values()]
    names += [w["traffic"] for w in CELLS.values()]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for kind in (MAN["configs"], list(CELLS.values()), METRICS):
        assert len({x["name"] for x in kind}) == len(kind)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    texts = ([c["why"] for c in MAN["configs"]]
             + [c["source"] for c in MAN["configs"]]
             + [w["why"] for w in CELLS.values()]
             + [m["layer"] for m in MAN["per_layer"]] + MAN["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in CELLS.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def reported(cell):
    return {m["name"] for m in MAN["end_to_end"]
            if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = reported(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m.get("workloads", CELLS) for m in MAN["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_moves_is_reported_by_each_of_its_cells(metric):
    m = {x["name"]: x for x in MAN["per_layer"]}[metric]
    cells = m.get("workloads", list(CELLS))
    assert cells and all(c in CELLS for c in cells)
    for c in cells:
        assert m["moves"] in reported(c), (metric, c)


def test_every_config_has_a_cell_and_files_exist():
    used = {w["config"] for w in CELLS.values()}
    for c in MAN["configs"]:
        assert c["name"] in used
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith(MAN["paths"][0] + "/")
        conf = json.loads(f.read_text())
        assert (ROOT / "portbench" / "drivers"
                / f"{conf['driver']}.py").is_file()
        assert set(c["reduced"]) <= set(conf)
    for name in CELLS:
        traffic = json.loads((ROOT / "portbench" / "traffic"
                              / f"{name}.json").read_text())
        assert traffic["config"] == CELLS[name]["config"]
    from portbench import harness
    for m in MAN["per_layer"]:
        assert harness.reader_path(m["name"]).is_file(), m["name"]
    assert (ROOT / MAN["command"][1]).is_file()


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in CELLS.values())
    assert four <= max(1, len(CELLS) // 4)


def test_full_check_fits_the_day():
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
