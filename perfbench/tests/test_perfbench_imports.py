"""What the benchmark loads and reads: no JAX, no JAX package, no old benchmark files.

Top-level module names are compared whole: ``us_video_medsam2_tpu_torch``
(the port, which the benchmark measures) begins with the JAX package's name
``us_video_medsam2_tpu`` and must not be mistaken for it.
"""

import ast
import json
import subprocess
import sys
import textwrap

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "us_video_medsam2_tpu"}
OLD_FILES = ("bench.py", "BASELINE.json", "BENCH_", "MULTICHIP_", "SERVE_BENCH_", "TRAIN_BENCH_")


def _sources(sub: str = ""):
    return [p for p in (harness.BENCH / sub).rglob("*.py") if "tests" not in p.relative_to(harness.BENCH).parts]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "us_video_medsam2_tpu_torch" not in tops, path
        assert tops - sys.stdlib_module_names <= {"torch", "numpy", "perfbench", "yaml"}, (path, tops)


def test_no_source_reads_the_old_benchmark():
    for path in _sources():
        text = path.read_text()
        for name in OLD_FILES:
            assert f'"{name}' not in text and f"'{name}" not in text, (path, name)


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process (the driver's imports, the port's,
    the reference's and the readers'), then its ``sys.modules``."""
    script = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, ".")
        from perfbench.tests.conftest import tiny_context
        from perfbench import harness
        ctx = tiny_context("t512.serve.n32x32")
        run = harness.driver(ctx.traffic["kind"]).run(ctx)
        bench = harness.benchmark()
        harness.metrics_of(bench, ctx.cell, False, run)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "us_video_medsam2_tpu_torch" in tops and not tops & FORBIDDEN


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "us_video_medsam2_tpu_torch_fake", object())
    assert "us_video_medsam2_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "us_video_medsam2_tpu.fake", object())
    assert "us_video_medsam2_tpu" in harness.forbidden_modules()
