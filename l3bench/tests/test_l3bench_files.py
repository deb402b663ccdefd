"""Every file of the benchmark loads, the harness finds each by name, and
BENCHMARK.json keeps to the shape the benchmark's checker takes."""

import json
import re

import pytest

from l3bench import generate, run

ROOT = run.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["l3bench"]
    assert BENCH["command"] == ["python3", "-m", "l3bench.run"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_budget_fits_the_full_benchmark():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names), names
    for kind in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in kind}) == len(kind)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
    assert all(_line(w) for w in BENCH["command"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_four_chip_cells_within_the_cap():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"l3bench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["model_type"] == c["name"] and cfg["source"] == c["source"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in WORKLOADS:
        e2e = {m["name"] for m in run.cell_metrics(BENCH, w, trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w
        assert run.cell_metrics(BENCH, w, trace=True), w


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert w in WORKLOADS
            e2e = {x["name"] for x in run.cell_metrics(BENCH, w, trace=False)}
            assert m["moves"] in e2e, (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_harness_finds_each_cell_by_name(workload):
    bench, entry, cell, config, mix = run.load_cell(workload)
    assert cell["driver"] in ("extract", "train")
    assert cell["precision"] in ("bf16", "f32")
    assert set(cell["check"]["limits"]) and all(v >= 0 for v in cell["check"]["limits"].values())
    assert config["model_type"] == entry["config"]
    assert mix["kind"] == ("clips" if cell["driver"] == "extract" else "avc_batches")
    assert cell["warmup_s"] >= 0 and cell["trace"]["units"] > 0


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader(metric):
    read = run.reader(metric)
    assert read({"cell": {"precision": "bf16"}, "config": {}, "chips": 1, "setup_s": 1.0, "window_s": 1.0,
                 "trace": None}) in (None, 1.0)


def test_every_traffic_file_loads_with_the_generator_of_its_kind():
    for path in sorted((ROOT / "l3bench" / "traffic").glob("*.json")):
        mix = generate.load_mix(path.stem)
        assert generate.generator(mix).__name__ == f"l3bench.generators.{mix['kind']}"


def test_a_mix_of_a_kind_without_a_generator_is_refused(tmp_path, monkeypatch):
    (tmp_path / "odd.json").write_text('{"kind": "poisson_requests"}')
    monkeypatch.setattr(generate, "TRAFFIC_DIR", tmp_path)
    with pytest.raises(ValueError, match="no generator"):
        generate.load_mix("odd")


def test_one_metric_layer_is_named_alike_and_every_metric_moves_one_it_names():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"setup_s", "windows_per_s", "pairs_per_s"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
    assert len({m["layer"] for m in BENCH["per_layer"] if m["name"].startswith("device_idle")}) == 1


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line_keeps_to_the_schema(trace, monkeypatch, capsys):
    import l3embedding_torch.embed.extract as extract

    monkeypatch.setattr(extract, "BUCKETS", (2, 4, 8))
    result = run.measure("linear.extract.f32", 2**31 + 1, 0.3, bool(trace), device="cpu", overrides={
        "mix": {"lengths": {"fixed": [[1.2, 3]]}, "pool_seconds": 4},
        "cell": {"warmup_s": 0, "trace": {"start": 0, "units": 1}, "check": {"sample": 1, "limits": {"clip_err": 5e-5}}}})
    assert not result.pop("forbidden")
    line = json.loads(run.result_line(result))
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert trace == ("busy_s" in line["device"] and "window_s" in line["device"])
    wanted = {m["name"] for m in run.cell_metrics(BENCH, "linear.extract.f32", bool(trace))}
    assert set(line["metrics"]) <= wanted and all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    if trace:
        assert all(len(line["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    else:
        assert set(line["metrics"]) == wanted
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("check clip_err ") and err[-1].endswith(" limit 5e-05")


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "l3bench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
