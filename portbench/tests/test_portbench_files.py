"""BENCHMARK.json and the files it names: parse, names, units, the
contract's limits, and every name found where the harness looks for it."""

import json
import math
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and (harness.ROOT / p).is_dir()
    assert (harness.ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(key):
    names = [e["name"] for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_parses_and_matches(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"] == f"portbench/configs/{conf['name']}.json"
    f = harness.load_json(harness.ROOT / conf["file"])
    assert f["source"] == conf["source"] and TEXT.match(conf["source"])
    assert f["why"] == conf["why"] and TEXT.match(conf["why"])
    assert f["reduced"] == conf["reduced"] and len(conf["reduced"]) <= 16
    assert (harness.HERE / "reference" / f"{f['reference']}.py").is_file()
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_file_parses_and_matches(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    f = harness.load_json(harness.HERE / "workloads" / f"{cell['name']}.json")
    assert f["config"] == cell["config"] and f["chips"] == cell["chips"] in (1, 4)
    assert f["why"] == cell["why"] and TEXT.match(cell["why"])
    assert NAME.match(cell["traffic"]) and cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert (harness.HERE / "traffic" / f"{f['runner']}.py").is_file()
    assert f["limits"] and all(v > 0 for v in f["limits"].values())


def test_pairs_and_four_chip_cells():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(CELLS)))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(c in CELLS for c in m.get("workloads", []))
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert harness.reader_path(m["name"]).is_file()
    if "roofline" in m["name"]:
        assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_setup_s_is_there_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        mine = [m for m in BENCH["end_to_end"] if harness.applies(m, cell)]
        assert len(mine) >= 2
        assert any(harness.applies(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_target_reported_by_every_cell_of_the_metric(m):
    assert m["workloads"], "a per-layer metric lists the cells that report it"
    target = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert harness.applies(target, cell)


def test_reader_found_by_longest_prefix(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    for n in ("a.b", "a.b.c.d"):
        (tmp_path / "metrics" / f"{n}.py").write_text("def read(run):\n    return 1.0\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    assert harness.reader_path("a.b.c.d").name == "a.b.c.d.py"
    assert harness.reader_path("a.b.c").name == "a.b.py"
    assert harness.reader_path("a.b.x.y").name == "a.b.py"
    with pytest.raises(FileNotFoundError):
        harness.reader_path("a.c")


def test_layer_names_are_consistent():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_shares_have_a_whole_step_share_beside_them():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(o.get("workloads", CELLS)) >= set(m.get("workloads", CELLS))
                       for o in BENCH["per_layer"])
