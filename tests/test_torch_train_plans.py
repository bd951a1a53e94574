"""PyTorch port, the one-program training step in training mode on every
plan structure: prompt mode (point, box, mask) x initial frames (1, 2) x an
extra corrected frame or none, JAX's own plan from ``_sample_plan`` on its
``k_plan`` split (``train_model.py:154``) under a key picked for each
structure, both packages' ``train_forward`` on that plan (the port's
``plan=``) with clicks at the error centre and boxes without noise in both
(``functools.partial``, so that neither draws) and memory-attention dropout
0: losses at rel 1e-4 and every gradient leaf at rel-L2 1e-3
(``tests/test_torch_train_graph.py::hold_plan_against_jax``). Position 1
runs the initial and the tracked branch and selects, so these cases hold
every selection of the port's step against JAX's ``lax.cond`` /
``lax.switch``.
"""

import pytest

from tests.test_torch_train_graph import MODES, STRUCTURES, TRAIN_SIM, hold_plan_against_jax


@pytest.mark.parametrize("mode,n_init,extra", STRUCTURES, ids=[f"{m}-init{n}-extra{e}" for m, n, e in STRUCTURES])
def test_training_step_on_every_plan_structure_matches_jax(mode, n_init, extra, monkeypatch):
    hold_plan_against_jax(TRAIN_SIM, True, (MODES[mode], n_init, extra), monkeypatch)
