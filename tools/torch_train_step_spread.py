#!/usr/bin/env python3
"""Spread of the PyTorch port's card-vs-host training-step agreement over seeds (one GPU).

    PYTHONPATH=. python3 tools/torch_train_step_spread.py [--seeds 0 1 2]

For each seed: ``sam2.1_hiera_t512`` weights and a moving-blob batch made
from that seed (``chip_smoke.build_train_model`` / ``make_train_batch``),
and chip_smoke.py's fixed-plan training step (T 4, 3 objects, mask prompts,
no dropout) run four times: on the card in bf16 twice with the JAX package's
opt-in kernel switches off, once with both on (the fused configuration), and
on the host CPU in f32. Prints, per seed, each card step's loss rel diff and
whole-gradient rel-L2 against the host step, and the fused step's against
the default card step. chip_smoke.py gates one seed (0) at loss rel <= 2e-2
and gradient rel-L2 <= 0.1; this shows how far other seeds fall from that
gate. Needs a CUDA device; about 30 s a seed, most of it the host step.
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)

    import torch

    from us_video_medsam2_tpu_torch.training.losses import LossConfig
    from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
    from us_video_medsam2_tpu_torch.training.train_step import TrainConfig, create_train_state, make_train_step

    if not torch.cuda.is_available():
        print("torch_train_step_spread: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fixed = TrainConfig(sim=TrainSimConfig(prob_to_use_pt_input=0.0, rand_init_cond_frames=False,
                                           num_init_cond_frames=1),
                        loss=LossConfig(weight_temporal=0.5, temporal_variant="consistency"),
                        optim=OptimConfig(total_steps=1000))
    runs = {"card": ("cuda", torch.bfloat16, False), "card again": ("cuda", torch.bfloat16, False),
            "card, fused": ("cuda", torch.bfloat16, True), "host": ("cpu", torch.float32, False)}

    def step(sd, dev, dtype, fused):
        with cs.fused_switches(fused):
            st = create_train_state(cs.build_train_model(sd, dropout=0.0), fixed, device=dev, dtype=dtype)
            m = make_train_step(fixed)(st, cs.make_train_batch(cs.HOST_T, st.model.cfg.image_size, dev), cs.SEED)
        return float(m["core_loss"]), {n: g.detach().float().cpu() for n, g in m["grads"].items()}

    def rel_l2(a, b):
        num = sum(float((a[n] - b[n]).square().sum()) for n in b)
        return (num / sum(float(b[n].square().sum()) for n in b)) ** 0.5

    print(cs.card_line(), flush=True)
    for seed in args.seeds:
        cs.SEED = seed  # chip_smoke's weights and batch are made from it
        sd = {k: v.clone() for k, v in cs.build_train_model().state_dict().items()}
        res = {k: step(sd, *v) for k, v in runs.items()}
        (lh, gh), (lc, gc) = res["host"], res["card"]
        out = {k: f"loss rel {abs(lo - lh) / abs(lh):.4e}, gradient rel-L2 {rel_l2(go, gh):.4e}"
               for k, (lo, go) in res.items() if k != "host"}
        lf, gf = res["card, fused"]
        out["card, fused vs card"] = f"loss rel {abs(lf - lc) / abs(lh):.4e}, gradient rel-L2 {rel_l2(gf, gc):.4e}"
        print(f"seed {seed}: " + "; ".join(f"{k} vs host: {v}" if "vs" not in k else f"{k}: {v}"
                                           for k, v in out.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
