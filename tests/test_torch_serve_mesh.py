"""PyTorch port: sharded serving (``parallel/mesh.py`` and
``batched_propagate(..., mesh=...)``) on the CPU at the MINI config
(fixture weights), against the JAX package's mesh.

1. Two gloo ranks, spawned as tests/test_torch_distributed.py spawns them,
   serve N 4 videos sharded 2 + 2: every rank returns all four, equal to the
   port's unsharded call on one process and to JAX's ``batched_propagate``
   over a 2-device mesh at ``assert_masks_close``'s tolerances (logits
   rtol / atol 1e-3, IoU > 0.999); N 3 raises ``ValueError`` on both ranks,
   as JAX's call raises; a rank whose weights differ makes both ranks raise,
   and the weights are checked once per predictor and mesh.
2. ``shard_batch`` gives each rank the block that JAX's ``PartitionSpec
   ("data")`` puts on its device, and ``gather_batch`` the global array.
3. ``create_mesh``: JAX's single -1 inferred, its size check, the process
   group joined from the environment, and an error without one.

JAX is imported inside the tests only: the spawned ranks import this module
and need none of it.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N, T = 4, 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def videos(n=N, t=T, size=256):
    rng = np.random.default_rng(0)
    vids = rng.standard_normal((n, t, size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        vids[i, :, ((yy - 100 - 5 * i) ** 2 + (xx - 120 + 4 * i) ** 2) < 40**2] += 3.0
    pts = np.array([[[120.0 - 4 * i, 100.0 + 5 * i]] for i in range(n)], np.float32)
    return vids, pts, np.ones((n, 1), np.int32)


def port_predictor(state_dict, cfg):
    from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor
    from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model

    model = SAM2Model(cfg)
    model.load_state_dict(state_dict, strict=True)
    return SAM2VideoPredictor(model.eval(), fill_hole_area=0, device="cpu")


def worker(rank, world, port, weights_path, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from us_video_medsam2_tpu_torch.inference import serve
    from us_video_medsam2_tpu_torch.parallel import distributed, mesh as pmesh

    sd, cfg = torch.load(weights_path, weights_only=False)
    mesh = pmesh.create_mesh(device_type="cpu")
    res = {"mesh": (mesh.mesh_dim_names, tuple(mesh.shape))}
    x = torch.arange(8).reshape(4, 2)
    res["shard"] = pmesh.shard_batch(x, mesh).clone()
    res["gather"] = pmesh.gather_batch(pmesh.shard_batch(x, mesh), mesh)
    res["shard_axis1"] = pmesh.shard_batch(x.T.numpy(), mesh, axis=1).copy()

    digests = []
    real = serve.weights_digest
    serve.weights_digest = lambda m: digests.append(1) or real(m)
    pred = port_predictor(sd, cfg)
    vids, pts, lbl = videos()
    res["served"] = serve.batched_propagate(pred, vids, pts, lbl, mesh=mesh)
    res["again"] = serve.batched_propagate(pred, vids, pts, lbl, mesh=mesh)
    res["digests"] = len(digests)
    try:
        serve.batched_propagate(pred, *videos(3), mesh=mesh)
        res["n3"] = None
    except ValueError as e:
        res["n3"] = str(e)

    other = port_predictor(sd, cfg)
    if rank == 1:
        with torch.no_grad():
            next(other.model.parameters()).add_(1e-3)
    try:
        serve.batched_propagate(other, vids[:2], pts[:2], lbl[:2], mesh=mesh)
        res["other_weights"] = None
    except RuntimeError as e:
        res["other_weights"] = str(e)
    res["digests_with_other"] = len(digests)
    res["objects"] = pmesh.all_gather_objects(rank)
    res["broadcast"] = pmesh.broadcast_object(f"from {rank}")
    pmesh.sync_hosts()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.destroy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tests.test_parity import MINI
    from tests.torch_port_helpers import mini_weights, port_config

    out = tmp_path_factory.mktemp("mesh")
    weights = str(out / "weights.pt")
    torch.save((mini_weights()[1], port_config(MINI)), weights)
    mp.spawn(worker, args=(2, free_port(), weights, str(out)), nprocs=2, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_two_gloo_ranks_serve_the_unsharded_result(ranks):
    from tests.torch_port_helpers import assert_masks_close, mini_port_predictor
    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate

    torch.set_num_threads(1)
    want = batched_propagate(mini_port_predictor(fill_hole_area=0), *videos())
    for r, got in enumerate(ranks):
        served = got["served"]
        assert served.shape == want.shape == (N, T, *want.shape[2:]) and served.dtype == torch.float32
        for i in range(N):
            assert_masks_close({f: served[i, f][None].numpy() for f in range(T)},
                               {f: want[i, f][None].numpy() for f in range(T)}, f"rank {r}, video {i}")
        assert torch.equal(got["again"], served)


def test_two_gloo_ranks_match_the_jax_mesh(ranks):
    import jax

    from tests.torch_port_helpers import assert_masks_close, mini_jax_predictor
    from us_video_medsam2_tpu.inference.serve import batched_propagate as jax_batched_propagate
    from us_video_medsam2_tpu.parallel.mesh import create_mesh as jax_create_mesh

    jmesh = jax_create_mesh(devices=jax.devices()[:2])
    jpred = mini_jax_predictor(fill_hole_area=0)
    want = np.asarray(jax_batched_propagate(jpred, *videos(), mesh=jmesh))
    for r, got in enumerate(ranks):
        for i in range(N):
            assert_masks_close({f: got["served"][i, f][None].numpy() for f in range(T)},
                               {f: want[i, f][None] for f in range(T)}, f"rank {r}, video {i} vs JAX")
    with pytest.raises(Exception):  # JAX's jit refuses 3 videos over 2 devices
        jax_batched_propagate(jpred, *videos(3), mesh=jmesh)
    for got in ranks:
        assert got["n3"] is not None and "does not divide" in got["n3"]


def test_a_rank_with_other_weights_raises_on_every_rank(ranks):
    for got in ranks:
        assert got["other_weights"] is not None and "different weights" in got["other_weights"]
        assert got["digests"] == 1  # two calls with one predictor and mesh: one check
        assert got["digests_with_other"] == 2


def test_shard_and_gather_are_the_jax_layout(ranks):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from us_video_medsam2_tpu.parallel.mesh import create_mesh as jax_create_mesh

    x = np.arange(8).reshape(4, 2)
    jmesh = jax_create_mesh(devices=jax.devices()[:2])
    arr = jax.device_put(x, NamedSharding(jmesh, P("data")))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, got in enumerate(ranks):
        assert got["mesh"] == (("data",), (2,))
        np.testing.assert_array_equal(got["shard"].numpy(), by_device[jmesh.devices[r]])
        np.testing.assert_array_equal(got["shard_axis1"], x.T[:, 2 * r: 2 * r + 2])
        np.testing.assert_array_equal(got["gather"].numpy(), x)
        assert got["objects"] == [0, 1] and got["broadcast"] == "from 0"


def test_create_mesh_sizes_in_one_process(monkeypatch):
    from us_video_medsam2_tpu_torch.parallel import distributed, mesh as pmesh

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.create_mesh(device_type="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        m = pmesh.create_mesh(device_type="cpu")
        assert distributed.is_initialized() and m.mesh_dim_names == ("data",) and tuple(m.shape) == (1,)
        m2 = pmesh.create_mesh(("data", "model"), (-1, 1), device_type="cpu")
        assert m2.mesh_dim_names == ("data", "model") and tuple(m2.shape) == (1, 1)
        for names, sizes in ((("data",), (2,)), (("data", "model"), (-1, -1)), (("data",), (1, 1))):
            with pytest.raises(ValueError):
                pmesh.create_mesh(names, sizes, device_type="cpu")
        x = torch.arange(6).reshape(3, 2)
        assert torch.equal(pmesh.shard_batch(x, m), x)
        assert torch.equal(pmesh.gather_batch(x, m), x)
        with pytest.raises(ValueError, match="no axis"):
            pmesh.shard_batch(x, m, mesh_axis="model")
    finally:
        distributed.destroy()
