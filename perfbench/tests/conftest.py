"""The benchmark's tests: the ``card`` marker and the fixtures they share.

Tests marked ``card`` run the cell's own sizes on a CUDA card and skip
elsewhere; whether there is a card is decided inside the ``card`` fixture,
never at import. The others run on the CPU at ``tiny64_test``.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs the cell's own sizes); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell's own sizes on the card")
    return "cuda"


def tiny_model() -> dict:
    """``tiny64_test`` with the builder's two overrides, as a configuration file holds a model."""
    from perfbench.reference.config import tiny64_test

    cfg = dataclasses.replace(tiny64_test(), dynamic_multimask_via_stability=True,
                              binarize_mask_from_pts_for_mem_enc=True)
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


TINY_TRAFFIC = {  # by traffic kind
    "batched": {"videos": 2, "frames": 4, "distinct_batches": 2},
    "interactive": {"min_frames": 3, "max_frames": 5, "distinct_videos": 2, "t_bucket": 16, "kept_requests": 2},
}


def tiny_context(cell: str, seed: int = 5, seconds: float = 0.3, dtype: str | None = None):
    """The cell's context at ``tiny64_test`` and small traffic, on the CPU
    (with ``dtype``, the program in that dtype instead of the configuration's)."""
    import time

    from perfbench import harness

    bench = harness.benchmark()
    kind = harness.load_json(harness.BENCH / "traffic" / f"{harness.cell_entry(bench, cell)['traffic']}.json")["kind"]
    return harness.context(cell, seed, seconds, False, "cpu", time.perf_counter(), bench,
                           overrides={"config": {"model": tiny_model(), **({"dtype": dtype} if dtype else {})},
                                      "traffic": TINY_TRAFFIC[kind]})
