"""PyTorch port, data parallelism (``parallel/distributed.py`` and the
reductions in ``training/train_step.py``): two gloo ranks spawned on the CPU
take one training step on their halves of a global batch, and must equal
the single-process step on the whole batch, also when the ranks hold
unequal numbers of valid objects. The property the JAX package's sharded
step has by construction (tests/test_train_step.py:109-154), with its
tolerances: the loss within 1e-6 relative, each gradient leaf within
1e-6 + 1e-5 · max|g| (the reductions only reassociate), the updated
parameters within 5e-7 + 1e-4 · base_lr.

``tiny64_test`` (TINY's shapes) with weights from a seed, memory-attention
dropout 0 (the residual and attention dropouts draw per rank), the default
prompt simulation with one correction click: box and click noise are drawn
for the global batch's objects and sliced, so the plan, the boxes and the
clicks of every object are the single process's.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from us_video_medsam2_tpu_torch.core.config import resolve_config
from us_video_medsam2_tpu_torch.core.weights import init_random_
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.training.losses import LossConfig
from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
from us_video_medsam2_tpu_torch.training.train_step import TrainBatch, TrainConfig, create_train_state, make_train_step

T, B, O = 2, 4, 2
CFG = TrainConfig(sim=TrainSimConfig(num_correction_pt_per_frame=1),
                  loss=LossConfig(weight_temporal=0.5, temporal_variant="consistency"),
                  optim=OptimConfig(total_steps=10))
VALID = {"equal": [[1, 1], [1, 1], [1, 1], [1, 1]], "unequal": [[1, 1], [1, 0], [0, 1], [0, 0]]}


def model():
    cfg = resolve_config("tiny64_test")
    cfg = dataclasses.replace(cfg, memory_attention=dataclasses.replace(cfg.memory_attention, dropout=0.0))
    return init_random_(SAM2Model(cfg), 0)


def batch(valid, start=0, stop=B):
    rng = np.random.default_rng(0)
    s = 64
    masks = np.zeros((T, B, O, s, s), bool)
    for b in range(B):
        for t in range(T):
            masks[t, b, 0, 10 + 3 * b + t: 40 + 2 * b, 12 + 4 * b: 36 + b] = True
            masks[t, b, 1, 40: 58, 5 + 5 * b + t: 30 + 5 * b] = True
    images = rng.standard_normal((T, B, s, s, 3)).astype(np.float32)
    ov = np.asarray(valid, bool)
    return TrainBatch(torch.from_numpy(images[:, start:stop]), torch.from_numpy(masks[:, start:stop]),
                      torch.from_numpy(ov[start:stop]))


def step(valid, start=0, stop=B, seed=5):
    torch.manual_seed(0)
    state = create_train_state(model(), CFG, device="cpu", dtype=torch.float32)
    m = make_train_step(CFG)(state, batch(valid, start, stop), seed)
    return {"loss": {k: float(v) for k, v in m.items() if k.startswith(("core", "loss"))},
            "grad_norm": float(m["grad_norm"]),
            "grads": {n: g.detach().clone() for n, g in m["grads"].items()},
            "params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
            "mode": int(m["plan"].mode)}


def worker(rank, world, port, valid, seed, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from us_video_medsam2_tpu_torch.parallel import distributed

    distributed.maybe_initialize_distributed("cpu")
    assert distributed.world() == world and distributed.rank() == rank
    n = B // world
    res = step(valid, rank * n, (rank + 1) * n, seed)
    res["gathered"] = distributed.all_gather_objects(rank)
    res["broadcast"] = distributed.broadcast_object(f"from {rank}")
    distributed.barrier()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.destroy()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# step seeds: 10 draws box prompts on one initial frame and corrects both
# frames with clicks (the noise drawn for the global batch's objects); 4 draws
# mask prompts on one initial frame
@pytest.mark.parametrize("seed", [10, 4])
@pytest.mark.parametrize("valid", list(VALID))
def test_two_gloo_ranks_equal_the_global_step(valid, seed, tmp_path):
    torch.set_num_threads(1)
    want = step(VALID[valid], seed=seed)
    assert want["mode"] == {10: 1, 4: 2}[seed]
    mp.spawn(worker, args=(2, free_port(), VALID[valid], seed, str(tmp_path)), nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for got in ranks:
        assert got["gathered"] == [0, 1] and got["broadcast"] == "from 0"
        assert got["mode"] == want["mode"]
        for k, v in want["loss"].items():
            np.testing.assert_allclose(got["loss"][k], v, rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for n, g in want["grads"].items():
            a, b = got["grads"][n].numpy(), g.numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 + 1e-5 * np.abs(b).max(), err_msg=n)
        for n, p in want["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), rtol=0,
                                       atol=5e-7 + 1e-4 * CFG.optim.base_lr, err_msg=n)
    assert want["loss"]["core_loss"] > 0 and want["grad_norm"] > 0


def test_the_halves_alone_are_not_the_global_step():
    """Without the reductions a rank's step is its own batch's: the check
    above would see the difference (the object count and the clicks of the
    second half differ)."""
    want = step(VALID["unequal"], seed=3)
    half = step(VALID["unequal"], 0, B // 2, seed=3)
    assert abs(half["loss"]["core_loss"] - want["loss"]["core_loss"]) > 1e-3 * abs(want["loss"]["core_loss"])


def test_without_a_group_everything_is_single_process(monkeypatch):
    from us_video_medsam2_tpu_torch.parallel import distributed

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.launched()
    assert distributed.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert (distributed.rank(), distributed.world()) == (0, 1) and not distributed.is_initialized()
    x = torch.ones(3)
    assert distributed.all_reduce_sum(x) is x
    g = {"a": torch.ones(2)}
    assert distributed.all_reduce_gradients(g) is g
    assert distributed.all_gather_objects(5) == [5] and distributed.broadcast_object(7) == 7
    distributed.barrier()
