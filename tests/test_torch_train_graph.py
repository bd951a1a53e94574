"""PyTorch port, the one-program training step: ``train_forward`` in eval
mode on JAX's plans against the JAX package's (training mode on every plan
structure: ``tests/test_torch_train_plans.py``), the device plan sampler
against ``_sample_plan``, the dropout seed as a device tensor, the
device-scalar AdamW against optax across its schedule, the step's capture
bookkeeping with a stub graph, and the resize's deterministic backward.

Plans: JAX's own plan from ``_sample_plan`` on its ``k_plan`` split
(``train_model.py:154``), a key picked for each structure (prompt mode x
initial frames 1 or 2 x an extra corrected frame or none); both packages run
on that plan (the port's ``train_forward(plan=...)``), with clicks at the
error centre and boxes without noise in both (``functools.partial``), so
that neither draws. Tolerances as ``tests/test_torch_training.py``: loss rel
1e-4, each gradient leaf rel-L2 1e-3 (abs 1e-6 below a norm of 1e-6). TINY
config, f32 on the CPU.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_training import LOSS, _jax_setup, _port_model, _video
from tests.torch_port_helpers import t
from us_video_medsam2_tpu.kernels import flash_dropout as jfd
from us_video_medsam2_tpu.training import losses as jlosses
from us_video_medsam2_tpu.training import optimizer as jopt
from us_video_medsam2_tpu.training import prompt_sampling as jps
from us_video_medsam2_tpu.training import train_model as jtm
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.kernels import flash_dropout as pfd
from us_video_medsam2_tpu_torch.models.memory_bank import init_memory_bank, write_memory
from us_video_medsam2_tpu_torch.training import prompt_sampling as pps
from us_video_medsam2_tpu_torch.training import train_model as ptm
from us_video_medsam2_tpu_torch.training import train_step as pts
from us_video_medsam2_tpu_torch.training.losses import LossConfig, multi_step_loss_stacked
from us_video_medsam2_tpu_torch.training.optimizer import AdamW, OptimConfig

FRAMES = 3
MODES = {"point": 0, "box": 1, "mask": 2}
# prompt mode x initial frames x extra corrected frames; mask prompts correct nothing
STRUCTURES = [(m, n, e) for m in ("point", "box") for n in (1, 2) for e in (0, 1)] + [
    ("mask", n, 0) for n in (1, 2)]
# training mode: every structure from one config (drawn n_init and corrected count)
TRAIN_SIM = dict(prob_to_use_pt_input=0.5, prob_to_use_box_input=0.5, num_init_cond_frames=2,
                 num_frames_to_correct=3, num_correction_pt_per_frame=2)
# eval mode: one initial frame, one more corrected frame
EVAL_SIM = dict(prob_to_use_pt_input_for_eval=0.5, prob_to_use_box_input=0.5, num_init_cond_frames_for_eval=1,
                num_frames_to_correct_for_eval=2, num_correction_pt_per_frame=2)


def _structure(plan) -> tuple:
    extra = int(np.sum(np.asarray(plan["should_correct"]) & ~np.asarray(plan["is_init"])))
    return int(plan["mode"]), int(plan["n_init"]), extra


@functools.lru_cache(maxsize=None)
def _key_for(sim_items, is_training, want) -> int:
    """The first PRNGKey(k) whose JAX plan (on train_forward's k_plan) has
    structure ``want``."""
    sim = jtm.TrainSimConfig(**dict(sim_items))
    sample = jax.jit(lambda k: jtm._sample_plan(jax.random.split(k)[0], sim, FRAMES, is_training))
    for k in range(500):
        if _structure(sample(jax.random.PRNGKey(k))) == want:
            return k
    raise AssertionError(f"no key gives {want}")


def _port_plan(plan) -> ptm.Plan:
    a = {k: torch.from_numpy(np.array(v)) for k, v in plan.items()}
    return ptm.Plan(a["mode"].long(), a["use_pt"].bool(), a["n_init"].long(), a["is_init"].bool(),
                    a["order"].long(), a["should_correct"].bool())


@functools.lru_cache(maxsize=None)
def _jax_step(sim_items, is_training):
    cfg, jmodel, params = _jax_setup()
    jsim = jtm.TrainSimConfig(**dict(sim_items))
    images, masks = _video()
    obj_valid = np.ones((1, 2), bool)

    def loss_fn(p, key):
        stacked, finals = jtm.train_forward(jmodel, p, key, jnp.asarray(images), jnp.asarray(masks), jsim,
                                            is_training=is_training,
                                            dropout_rng=jax.random.PRNGKey(2) if is_training else None)
        out = jlosses.multi_step_loss_stacked(jlosses.LossConfig(**LOSS), stacked,
                                              jnp.asarray(obj_valid).reshape(-1), final_logits_by_frame=finals)
        return out["core_loss"], out

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _no_draws(monkeypatch):
    """Clicks at the error centre and boxes without noise in both packages
    (the functions each ``train_model`` calls): the step draws nothing."""
    def centre(pkg):
        return lambda gt, pred, method, *a, **k: pkg.get_next_point(gt, pred, "center", None)

    for tm, ps in ((jtm, jps), (ptm, pps)):
        monkeypatch.setattr(tm, "get_next_point", centre(ps))
        monkeypatch.setattr(tm, "sample_box_points", functools.partial(ps.sample_box_points, noise=0.0))


def hold_plan_against_jax(sim_kw, is_training, want, monkeypatch):
    """Both packages' step on JAX's plan of structure ``want``: losses and
    every gradient."""
    _no_draws(monkeypatch)
    items = tuple(sorted(sim_kw.items()))
    key = jax.random.PRNGKey(_key_for(items, is_training, want))
    cfg, _, params = _jax_setup()
    jplan = jtm._sample_plan(jax.random.split(key)[0], jtm.TrainSimConfig(**sim_kw), FRAMES, is_training)
    assert _structure(jplan) == want
    (_, want_losses), jgrads = _jax_step(items, is_training)(params, key)

    images, masks = _video()
    model = _port_model(cfg, params)
    stacked, finals, plan = ptm.train_forward(model, torch.Generator().manual_seed(0), t(images), t(masks),
                                              ptm.TrainSimConfig(**sim_kw), is_training, plan=_port_plan(jplan))
    got = multi_step_loss_stacked(LossConfig(**LOSS), stacked, torch.ones(2, dtype=torch.bool),
                                  final_logits_by_frame=finals)
    for k, v in want_losses.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    got["core_loss"].backward()
    want_grads = from_jax_params(jgrads)
    for name, p in model.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        wn = np.linalg.norm(w)
        if wn > 1e-6:
            rel = np.linalg.norm(g - w) / wn
            assert rel <= 1e-3, f"{name}: gradient rel-L2 {rel:.3e} (norm {wn:.3e})"
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ["point", "box", "mask"])
def test_eval_step_on_jax_plans_matches_jax(mode, monkeypatch):
    """Eval mode (the binarized click memories, the stability fallback): one
    initial frame, and with clicks or a box one more corrected frame."""
    hold_plan_against_jax(EVAL_SIM, False, (MODES[mode], 1, int(mode != "mask")), monkeypatch)


# ------------------------------------------------------------- plan sampler
class _Draws:
    """A stand-in for ``jax`` inside ``jtm._sample_plan``: each of its six
    keys reads the given uniform(s); bernoulli is ``u < p`` and randint
    ``lo + floor(u·(hi - lo))``, the port's own mapping of a uniform."""

    def __init__(self, u: dict):
        names = ("pt", "box", "n_init", "init", "n_corr", "corr")
        draws = {i: np.asarray(u[n]) for i, n in enumerate(names)}
        self.random = types.SimpleNamespace(
            split=lambda key, n: list(range(n)),
            bernoulli=lambda k, p: jnp.asarray(draws[k] < np.float32(p)),
            randint=lambda k, shape, lo, hi: jnp.minimum(
                lo + jnp.floor(jnp.float32(draws[k]) * (hi - lo)).astype(jnp.int32), hi - 1),
            uniform=lambda k, shape: jnp.asarray(draws[k]))


@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("frames", [1, 2, 4, 6])
def test_device_sampler_matches_jax_sample_plan_on_the_same_draws(frames, is_training, monkeypatch):
    sims = [ptm.TrainSimConfig(),
            ptm.TrainSimConfig(prob_to_use_pt_input=1.0, prob_to_use_box_input=0.5, num_frames_to_correct=3,
                               num_init_cond_frames=3, prob_to_use_pt_input_for_eval=0.5,
                               num_init_cond_frames_for_eval=2, num_frames_to_correct_for_eval=3)]
    gen = torch.Generator().manual_seed(frames)
    for sim in sims:
        for _ in range(25):
            u = ptm.draw_plan_uniforms(gen, frames, "cpu")
            got = ptm.plan_from_uniforms(u, sim, frames, is_training)
            monkeypatch.setattr(jtm, "jax", _Draws({k: v.numpy() for k, v in u.items()}))
            want = jtm._sample_plan(None, jtm.TrainSimConfig(**dataclasses.asdict(sim)), frames, is_training)
            monkeypatch.undo()
            for k in want:
                np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(want[k]), err_msg=k)


def test_sample_plan_stays_on_its_device_and_draws_each_structure():
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        p = ptm.sample_plan(gen, ptm.TrainSimConfig(), 4, True)
        assert p.order.dtype == torch.long and p.mode.dim() == 0 and p.is_init.shape == (4,)
        assert bool(p.is_init[0]) and sorted(p.order.tolist()) == [0, 1, 2, 3]
        assert int(p.is_init.sum()) == int(p.n_init)
        seen.add((int(p.mode), int(p.n_init), int(p.should_correct.sum())))
    # TrainSimConfig(): box or mask, 1 or 2 initial frames, 1-2 corrected frames with boxes
    assert seen == {(1, 1, 1), (1, 1, 2), (1, 2, 2), (2, 1, 0), (2, 2, 0)}
    assert ptm.possible_modes(ptm.TrainSimConfig(), 4, True) == (1, 2)
    assert ptm.possible_modes(ptm.TrainSimConfig(), 4, False) == (2,)
    assert ptm.possible_modes(ptm.TrainSimConfig(), 1, True) == (1,)


# ---------------------------------------------------------- dropout seed
@pytest.mark.parametrize("seed", [0, 7, -(2**31), 2**31 - 1, 123456789])
def test_tensor_seed_gives_the_int_seeds_keep_mask(seed):
    want = np.asarray(jfd.keep_mask_reference(6, 33, 70, seed, 0.1))
    st = torch.tensor(seed, dtype=torch.int32)
    np.testing.assert_array_equal(pfd.keep_mask(6, 33, 70, st, 0.1).numpy(), want)
    np.testing.assert_array_equal(pfd.keep_mask(6, 33, 70, seed, 0.1).numpy(), want)
    assert pfd.seed_operand(seed, torch.device("cpu")).item() == seed
    assert pfd.seed_operand(st, torch.device("cpu")) is not None
    rng = np.random.default_rng(1)
    q, k, v = (t(rng.standard_normal((1, 2, 33, 16)).astype(np.float32)) for _ in range(3))
    mask = torch.ones(1, 33, dtype=torch.bool)
    a = pfd.flash_attention_train_plain(q, k, v, mask, st, 0.1)
    b = pfd.flash_attention_train_plain(q, k, v, mask, seed, 0.1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    pa = pfd.flash_dropout_fwd_split_partials(q, k, v, mask, st, 0.1, 2)
    pb = pfd.flash_dropout_fwd_split_partials(q, k, v, mask, seed, 0.1, 2)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_seed_operand_checks_and_draw_seed_is_an_int32_on_the_device():
    with pytest.raises(ValueError, match="int32"):
        pfd.seed_operand(torch.tensor(3), torch.device("cpu"))
    assert pfd.seed_operand(2**31, torch.device("cpu")).item() == -(2**31)  # an int wraps as int32
    s = pfd.draw_seed(torch.Generator().manual_seed(0), "cpu")
    assert s.dtype == torch.int32 and s.dim() == 0
    again = pfd.draw_seed(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(s, again)


def test_write_memory_takes_a_device_is_cond():
    for is_cond in (True, False):
        a = init_memory_bank(2, 4, 3, 5, 6)
        b = init_memory_bank(2, 4, 3, 5, 6)
        mm, ptr = torch.randn(2, 3, 5), torch.randn(2, 6)
        write_memory(a, torch.tensor(2), mm, ptr, torch.tensor(is_cond))
        write_memory(b, 2, mm, ptr, is_cond)
        for x, y in ((a.maskmem, b.maskmem), (a.obj_ptr, b.obj_ptr), (a.valid, b.valid), (a.is_cond, b.is_cond)):
            assert torch.equal(x, y)


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("accum_steps", [1, 2])
def test_device_scalar_adamw_matches_optax_across_the_schedule(accum_steps):
    """12 optimizer updates over total_steps 10: the bias corrections' early
    steps and the cosine clipped at its end; with accumulation every
    micro-step runs the same device ops and the update is kept at the
    group's last. The state's counts in the JAX layout."""
    from tests.test_torch_training_parts import _tiny_params

    params = _tiny_params()
    cfg = dict(total_steps=10, accum_steps=accum_steps)
    tx = jopt.build_optimizer(params, jopt.OptimConfig(**cfg))
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    port = {k: v.clone() for k, v in from_jax_params(params).items()}
    opt = AdamW(port, OptimConfig(**cfg))
    assert opt.count_t.dtype == torch.int32 and opt.count_t.device == next(iter(port.values())).device
    rng = np.random.default_rng(3)
    for step in range(12 * accum_steps):
        jgrads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.05).astype(np.float32), params)
        params, state = update(jgrads, state, params)
        opt.step(from_jax_params(jgrads))
        if step % 4 == 3 or step == 12 * accum_steps - 1:
            want = from_jax_params(params)
            for name, p in port.items():
                w = want[name].numpy()
                d = np.linalg.norm(p.numpy() - w) / max(np.linalg.norm(w), 1e-30)
                assert d <= 1e-6, f"step {step} {name}: rel {d:.3e}"
    assert opt.count == 12 and opt.mini_step == 0
    inner = state.inner_opt_state if accum_steps > 1 else state
    assert int(inner["count"]) == opt.count
    if accum_steps > 1:
        assert int(state.mini_step) == opt.mini_step


# ------------------------------------------------------- capture bookkeeping
def _stub_graphs(monkeypatch):
    """The capture runs the body eagerly and keeps what it returns; a replay
    runs it again into the kept outputs' place (the graph's memory)."""
    from us_video_medsam2_tpu_torch.inference import graphs

    def capture(self, body, generators=()):
        self.body = body
        self.outputs = body()
        return self.outputs

    def replay(self):
        self.outputs = self.body()

    monkeypatch.setattr(graphs.FrameGraph, "warm_up_and_capture", capture)
    monkeypatch.setattr(graphs.FrameGraph, "replay", replay)


def test_step_graph_is_kept_under_its_updates_and_loads_and_dropped_for_new_memory(monkeypatch):
    _stub_graphs(monkeypatch)
    cfg, _, params = _jax_setup()
    images, masks = _video()
    model = _port_model(cfg, params)
    tcfg = pts.TrainConfig(sim=ptm.TrainSimConfig(num_correction_pt_per_frame=1), loss=LossConfig(**LOSS),
                           optim=OptimConfig(total_steps=10))
    state = pts.create_train_state(model, tcfg, device="cpu", dtype=torch.float32)
    batch = pts.TrainBatch(t(images), t(masks), torch.ones(1, 2, dtype=torch.bool))
    step = pts.make_train_step(tcfg)
    cap = step.captured

    def run(seed):
        opt = state.optimizer
        written = list(model.parameters()) + opt.state_tensors()
        return cap.run(cap.key(model, batch), batch, seed, written + list(model.buffers()), written,
                       lambda b, gen: step.body(state, b, gen), model)

    versions = [p._version for p in model.parameters()]
    first = run(1)
    assert cap.captures == 1 and np.isfinite(float(first["core_loss"]))
    run(2)
    assert cap.captures == 1  # replayed: its own in-place updates keep the graph
    assert all(p._version > v for p, v in zip(model.parameters(), versions))
    with torch.no_grad():  # a checkpoint load copies into the same tensors
        model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()})
        state.optimizer.load_state_dict(state.optimizer.state_dict(model.cfg))
    run(3)
    assert cap.captures == 1
    model.no_mem_embed.data = model.no_mem_embed.data.clone()  # other memory: captured anew
    run(4)
    assert cap.captures == 2 and len(cap.graphs) == 1
    big = pts.TrainBatch(t(images)[:2], t(masks)[:2], batch.obj_valid)
    assert cap.key(model, big) != cap.key(model, batch)


def test_step_graphs_of_one_model_share_a_memory_pool(monkeypatch):
    """A model's train and eval step graphs capture into the pool of its
    last step graph while that lives; another model's, or a model whose
    graphs are all gone, get a new pool."""
    from us_video_medsam2_tpu_torch.utils import graphs as ugraphs

    made = iter(range(10))

    class Pool:
        def __init__(self, pool):
            self.id = pool

        def pool(self):
            return self.id

    def capture(self, body, generators=()):
        self.graph = Pool(self.pool if self.pool is not None else ("new", next(made)))
        self.outputs = body()
        return self.outputs

    monkeypatch.setattr(ugraphs.FrameGraph, "warm_up_and_capture", capture)
    batch = pts.TrainBatch(torch.zeros(1, 1, 2, 2, 3), torch.zeros(1, 1, 1, 2, 2, dtype=torch.bool),
                           torch.ones(1, 1, dtype=torch.bool))
    a, b = torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)
    train, ev, other = pts._Captured(), pts._Captured(), pts._Captured()

    def capture_for(cap, model):
        cap.run("key", batch, 0, list(model.parameters()), [], lambda bufs, gen: {}, model)
        return cap.graphs["key"]

    first = capture_for(train, a)
    assert capture_for(ev, a).graph.pool() == first.graph.pool() == ("new", 0)
    assert capture_for(other, b).graph.pool() == ("new", 1)
    del first
    for cap in (train, ev):
        cap.graphs.clear()
        cap.last = None
    assert capture_for(train, a).graph.pool() == ("new", 2)


def test_eager_steps_with_one_seed_draw_the_same_step():
    cfg, _, params = _jax_setup()
    images, masks = _video()
    tcfg = pts.TrainConfig(sim=ptm.TrainSimConfig(num_correction_pt_per_frame=1), loss=LossConfig(**LOSS),
                           optim=OptimConfig(total_steps=10))
    batch = pts.TrainBatch(t(images), t(masks), torch.ones(1, 2, dtype=torch.bool))
    runs = []
    for _ in range(2):
        state = pts.create_train_state(_port_model(cfg, params), tcfg, device="cpu", dtype=torch.float32)
        m = pts.make_train_step(tcfg)(state, batch, 11)
        runs.append((m, {n: p.detach().clone() for n, p in state.model.named_parameters()}))
    (a, pa), (b, pb) = runs
    assert torch.equal(a["core_loss"], b["core_loss"])
    assert all(torch.equal(a["grads"][n], b["grads"][n]) for n in a["grads"])
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    for k in ("mode", "n_init", "order", "should_correct"):
        assert torch.equal(getattr(a["plan"], k), getattr(b["plan"], k))


# ------------------------------------------------------------------ resize
@pytest.mark.parametrize("mode", ["linear", "cubic"])
@pytest.mark.parametrize("shapes", [(32, 32, 128, 128), (7, 7, 64, 48), (24, 20, 12, 16), (5, 9, 13, 4)])
def test_resize_backward_is_interpolates_adjoint_by_matrices(mode, shapes):
    """With a gradient wanted, ``resize2d``'s forward is ``F.interpolate``'s
    bits and its backward (matrix products, deterministic on the card)
    agrees with ``F.interpolate``'s own; ``interp_matrix`` is its weights."""
    import torch.nn.functional as F

    from us_video_medsam2_tpu_torch.ops.resize import interp_matrix, resize2d

    hi, wi, ho, wo = shapes
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, hi, wi, 3, generator=gen).requires_grad_()
    g = torch.randn(2, ho, wo, 3, generator=gen)
    y = resize2d(x, (ho, wo), mode)
    (y * g).sum().backward()
    got, x.grad = x.grad, None
    ref = F.interpolate(x.permute(0, 3, 1, 2), size=(ho, wo), mode={"linear": "bilinear", "cubic": "bicubic"}[mode],
                        align_corners=False).permute(0, 2, 3, 1)
    (ref * g).sum().backward()
    assert torch.equal(y, ref)
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-4)
    mats = torch.einsum("oh,bhwc,pw->bopc", interp_matrix(hi, ho, mode, "cpu"), x.detach(),
                        interp_matrix(wi, wo, mode, "cpu"))
    torch.testing.assert_close(mats, ref.detach(), rtol=1e-5, atol=1e-5)
