"""BENCHMARK.json against the contract the benchmark is held to, and the
harness finding every cell, configuration, traffic mix and metric by name."""

import json
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES, m
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for x in bench["workloads"] + bench["configs"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]


def test_entries_have_just_their_keys(bench):
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in bench["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in bench["workloads"])
    e2e_keys = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) in (e2e_keys, e2e_keys | {"workloads"}) for m in bench["end_to_end"])
    pl_keys = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) in (pl_keys, pl_keys | {"workloads"}) for m in bench["per_layer"])


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "drivers", "metrics", "limits"])
def test_every_name_has_its_file(bench, kind):
    if kind == "configs":
        for c in bench["configs"]:
            cfg = harness.load_json(harness.ROOT / c["file"])
            assert c["file"].startswith("perfbench/") and cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    elif kind in ("traffic", "drivers"):
        for w in bench["workloads"]:
            t = harness.load_json(harness.BENCH / "traffic" / f"{w['traffic']}.json")
            if kind == "drivers":
                assert hasattr(harness.driver(t["kind"]), "run") and hasattr(harness.driver(t["kind"]), "control")
    elif kind == "metrics":
        for m in bench["end_to_end"] + bench["per_layer"]:
            assert callable(harness.reader(m["name"]))
    else:
        for w in bench["workloads"]:
            limits = harness.load_json(harness.BENCH / "limits" / f"{w['name']}.json")
            assert limits and set(limits) <= {"gap_ratio_mean", "gap_ratio_max"}


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, w
        per_layer = harness.cell_metrics(bench, w["name"], "per_layer")
        assert per_layer, w
        assert all(m["moves"] in e2e for m in per_layer), w


def test_roofline_and_mfu_names(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^[a-z_]+_roofline(\.[a-z]+)?$", m["name"]) and m["unit"] == "%"
    kernels_moves = {m["moves"] for m in bench["per_layer"] if "roofline" in m["name"]}
    mfu_moves = {m["moves"] for m in bench["per_layer"] if "mfu" in m["name"]}
    assert kernels_moves <= mfu_moves


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric, added
    to a copy as new files and BENCHMARK.json entries, run end to end at
    tiny64 on the CPU, with no file of the copy edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, copy / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(harness.ROOT / "us_video_medsam2_tpu_torch", copy / "us_video_medsam2_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    before = {p: p.read_bytes() for p in (copy / "perfbench").rglob("*") if p.is_file()}
    from perfbench.tests.conftest import tiny_model

    cfg = {"name": "tiny", "source": "test", "dtype": "float32", "fill_hole_area": 0, "reduced": [],
           "model": tiny_model()}
    (copy / "perfbench/configs/tiny.json").write_text(json.dumps(cfg))
    (copy / "perfbench/traffic/serve.n2x3.json").write_text(json.dumps(
        {"kind": "batched", "videos": 2, "frames": 3, "distinct_batches": 1, "traced_batches": 1}))
    (copy / "perfbench/limits/tiny.serve.n2x3.json").write_text(json.dumps({"gap_ratio_mean": 0.1, "gap_ratio_max": 0.1}))
    (copy / "perfbench/metrics/frames_seen.tiny.py").write_text("def read(run):\n    return float(run.frames)\n")
    bench["configs"].append({"name": "tiny", "source": "test", "file": "perfbench/configs/tiny.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny.serve.n2x3", "config": "tiny", "traffic": "serve.n2x3", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny.serve.n2x3")  # frames_per_s
    bench["per_layer"].append({"name": "frames_seen.tiny", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "frames_per_s",
                               "workloads": ["tiny.serve.n2x3"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent("""
        import json, sys, time
        sys.path.insert(0, ".")
        from perfbench import harness
        bench = harness.benchmark()
        ctx = harness.context("tiny.serve.n2x3", 3, 0.2, False, "cpu", time.perf_counter(), bench)
        run = harness.driver(ctx.traffic["kind"]).run(ctx)
        e2e = harness.result_line(bench, ctx, run, 1)
        ctx.trace = True
        print(json.dumps([e2e, harness.metrics_of(bench, ctx.cell, True, run)]))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=copy, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    e2e, per_layer = json.loads(out.stdout.strip().splitlines()[-1])
    assert e2e["correct"], e2e["checks"]  # the program in f32 against the f32 reference
    assert set(e2e["metrics"]) == {"frames_per_s", "peak_mem_gib", "setup_s"} - {"peak_mem_gib"}
    assert per_layer["frames_seen.tiny"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and perfbench/ a run exits
    non-zero with no result line, and the harness refuses a port imported
    from anywhere but its checkout."""
    shutil.copytree(harness.BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "t512.interactive", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(harness.ROOT)!r})  # the port importable, but from another tree
        sys.path.insert(0, ".")
        from perfbench import harness
        try:
            harness.program_in_checkout()
        except harness.Refused as e:
            print("refused:", e)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert "refused: the program was imported from" in out.stdout, out.stderr[-2000:]
