"""BENCHMARK.json and every file it names are found by name and keep to
the benchmark's contract."""
import json
import math
import os
import re

import pytest

from amc_bench import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|filters|units|frame_len|kernel)")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["amc_bench"] and B["command"][:2] == ["python3", "-m"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


def test_check_fits_with_24_cells():
    n = 24
    total = (2 + 14 * n) * (B["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_keys():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("amc_bench/")
        assert all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
        names.append(c["name"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_files_found_by_name(cell):
    c = spec.load(cell)
    assert c.traffic["kind"] in ("stream", "frames")
    assert c.settings["limits"] and all(isinstance(v, (int, float)) for v in c.settings["limits"].values())
    assert os.path.isfile(c.path(c.config["weights"]))
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configs_state_published_widths(c):
    """Each configuration states its architecture's published widths, but
    for the keys its ``reduced`` lists."""
    cfg = spec.load_config(os.path.join(spec.ROOT, c["file"]))
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    published = spec.architecture(cfg).PUBLISHED
    assert published and set(c["reduced"]) <= set(cfg)
    for key, value in published.items():
        if key not in c["reduced"]:
            assert cfg[key] == value, (key, cfg[key], value)


@pytest.mark.parametrize("change", [{"architecture": None}, {"architecture": "nosuch"},
                                    {"precision": None}])
def test_config_without_architecture_or_key_is_refused(tmp_path, change):
    """A configuration that names no architecture, one with no module, or
    lacks a key every configuration states, is refused by name."""
    cfg = json.load(open(os.path.join(spec.HERE, "configs", "vtcnn2_rml11_int8.json")))
    for key, value in change.items():
        cfg.pop(key) if value is None else cfg.update({key: value})
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(KeyError) as err:
        spec.load_config(str(path))
    assert ("vtcnn2" if "architecture" in change else "precision") in str(err.value)


def test_traffic_and_cells_are_data():
    for sub, ext in (("traffic", ".json"), ("workloads", ".json"), ("configs", ".json")):
        for f in os.listdir(os.path.join(spec.HERE, sub)):
            assert f.endswith(ext)
    reported = {m["name"] for m in B["end_to_end"] + B["per_layer"]}
    readers = {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics")) if f.endswith(".py")}
    assert reported <= readers


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, math.floor(len(B["workloads"]) / 4))
