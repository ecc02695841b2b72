"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
a cell, a configuration, a traffic mix and a per-layer metric that are
added as new files and entries, with no file of the harness edited; a
configuration of another block family or policy head is also run and
judged that way."""

import json
import re
import shutil

import pytest
from conftest import MIX, NESTED, ROOT, tiny_traffic
from port_bench import run as RUN

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["name"] in {w["config"] for w in b["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)


def test_every_cell_has_its_files():
    b = _bench()
    for w in b["workloads"]:
        h = RUN.Harness(ROOT, b, w["name"], 1, "cpu")
        assert h.driver().setup and h.limits and h.end_to_end() and h.per_layer()
        assert (ROOT / "port_bench" / "drivers" / f"{h.wl['driver']}.py").is_file()
        for m in h.per_layer():
            assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()
        reported = {m["name"] for m in h.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2


def test_new_cell_config_traffic_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    cfg = json.loads((root / "port_bench/configs/b6c96.json").read_text())
    cfg["name"] = "b4c64"
    cfg["net"].update(residual_channels=64, stack=cfg["net"]["stack"][:4])
    (root / "port_bench/configs/b4c64.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "port_bench/workloads/search-midgame-b256.json").read_text())
    traffic["batch"] = 512
    (root / "port_bench/workloads/search-midgame-b512.json").write_text(json.dumps(traffic))
    (root / "port_bench/limits/search-b4c64-midgame.json").write_text(json.dumps(
        {"board_mismatches": 0, "tree_faults": 0, "prior_tv_max": 0.05, "value_gap_max": 0.1}))
    b["end_to_end"].append({"name": "playouts_per_s", "unit": "playouts/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["search-b4c64-midgame"]})
    (root / "port_bench/metrics/sims_per_search.search.py").write_text(
        "def read(ctx):\n    return ctx.unit['sims']\n")
    b["configs"].append({"name": "b4c64", "source": "https://example.org/b4c64",
                         "file": "port_bench/configs/b4c64.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "search-b4c64-midgame", "config": "b4c64",
                           "traffic": "search-midgame-b512", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "sims_per_search.search", "unit": "sims", "better": "higher",
                           "source": "program_counter", "layer": "search",
                           "moves": "playouts_per_s", "workloads": ["search-b4c64-midgame"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    h = RUN.Harness(root, b, "search-b4c64-midgame", 1, "cpu")
    assert h.cfg["net"]["residual_channels"] == 64 and h.wl["batch"] == 512
    assert h.limits["board_mismatches"] == 0
    assert [m["name"] for m in h.per_layer()] == ["sims_per_search.search"]
    reader = RUN.load(root / "port_bench/metrics/sims_per_search.search.py", "m")
    assert reader.read(type("C", (), {"unit": {"sims": 96}})()) == 96
    # the cell already there sees none of it
    old = RUN.Harness(root, b, "selfplay-b6c96-19x19", 1, "cpu")
    assert "sims_per_search.search" not in [m["name"] for m in old.per_layer()]
    assert [m["name"] for m in old.end_to_end()] == ["positions_per_s", "setup_s"]


FAMILIES = {"nested-bottleneck": {"stack": NESTED},
            "mixer-replk": {"stack": MIX, "policy_head_type": "RepLK"}}


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in (root / "port_bench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_new_block_family_config_is_found_and_judged(family, tmp_path):
    """A configuration of another block family (a test-size net) under the
    search traffic, added as a file and entries: found, run through the
    whole cell on the CPU at the test size, and judged correct, with every
    file of the harness as it was."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    name, cell = f"b2c16-{family}", f"search-b2c16-{family}"
    cfg = json.loads((root / "port_bench/configs/b6c96.json").read_text())
    cfg["name"] = name
    cfg["net"].update(residual_channels=16, policy_head_channels=8, value_head_channels=8,
                      **FAMILIES[family])
    (root / f"port_bench/configs/{name}.json").write_text(json.dumps(cfg))
    (root / f"port_bench/limits/{cell}.json").write_text(
        (root / "port_bench/limits/search-b15c192-midgame.json").read_text())
    b["configs"].append({"name": name, "source": "https://example.org/" + name,
                         "file": f"port_bench/configs/{name}.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": cell, "config": name, "traffic": "search-midgame-b256",
                           "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "search-b15c192-midgame" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    h = tiny_traffic(RUN.Harness(root, b, cell, 2**31 + 55, "cpu"))
    assert h.cfg["net"]["stack"] == FAMILIES[family]["stack"]
    assert [m["name"] for m in h.end_to_end()] == ["playouts_per_s", "setup_s"]
    res = RUN.run_cell(h, 0.5, 0, lambda: None)
    assert res["correct"], res["limits"]
    assert set(res["metrics"]) == {"playouts_per_s", "setup_s"}
    added = {f"port_bench/configs/{name}.json", f"port_bench/limits/{cell}.json"}
    copy = _files(root)
    assert {str(p) for p in set(copy) - set(_files(ROOT))} == added
    assert all(copy[p] == v for p, v in _files(ROOT).items())
