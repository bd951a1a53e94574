"""Training launcher.

Counterpart of the JAX package's ``apps/train.py`` (reference
training/train.py:28-296), with its flags letter for letter and
``--device`` (``cuda`` by default; ``cpu`` runs the plain versions). One
process a card: under ``torchrun`` the processes join one
``torch.distributed`` group (``parallel/distributed.py``) and
``--batch_size`` counts videos per process. Writes the resolved-config
snapshots (reference train.py:142-153), ``train_stats.json``,
``best_stats.json``, ``checkpoint.npz`` and ``best_checkpoint.npz`` with
their ``.meta.json`` to ``--out_dir``, and resumes from its own
``checkpoint.npz`` there.

Usage:
  python -m us_video_medsam2_tpu_torch.apps.train --data_dir data/train_npz \\
      --out_dir work_dir/exp1 [--init_ckpt sam2.1_hiera_tiny.pt] \\
      [--num_frames 4] [--epochs 100] [--temporal_loss consistency]
  torchrun --nproc_per_node N -m us_video_medsam2_tpu_torch.apps.train ...
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os


def build_model(cfg, init_ckpt, seed: int = 0):
    """f32 ``SAM2Model(cfg)`` on the CPU: weights made from ``seed``, then
    those of ``init_ckpt`` loaded over them (``core/build.py::load_params``
    without the strict check, as the JAX launcher loads; the model's keys the
    checkpoint lacks keep their made values and are logged)."""
    from us_video_medsam2_tpu_torch.core.build import load_params
    from us_video_medsam2_tpu_torch.core.weights import init_random_
    from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model

    model = init_random_(SAM2Model(cfg), seed)
    if init_ckpt is None:
        logging.warning("no checkpoint given: weights made from seed %d", seed)
        return model
    sd = load_params(cfg, init_ckpt, strict=False)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected:
        raise RuntimeError(f"{init_ckpt}: keys the model does not have: {unexpected[:5]}")
    if missing:
        logging.warning("%s holds no %d of the model's keys (kept from seed %d): %s", init_ckpt, len(missing),
                        seed, missing[:8])
    return model


def make_loader(data_dir, curriculum, num_frames, max_num_objects, batch_size, resolution, seed,
                process_index=0, process_count=1):
    """The launcher's loader: the ``curriculum``'s NPZ dataset, the random
    uniform sampler, GFTE_3.yaml's augmentations at ``resolution``,
    ``batch_size`` videos a batch on each of ``process_count`` processes."""
    from us_video_medsam2_tpu_torch.training.data import (
        AESCurriculumNPZRawDataset,
        NeuroSpectralNPZRawDataset,
        NPZRawDataset,
        QuantumNPZRawDataset,
        RandomUniformSampler,
        TrainMixedVideoLoader,
        VOSDataset,
        default_train_transforms,
    )

    raw_cls = {
        "none": NPZRawDataset,
        "quantum": QuantumNPZRawDataset,
        "aes": AESCurriculumNPZRawDataset,
        "neurospectral": NeuroSpectralNPZRawDataset,
    }[curriculum]
    dataset = VOSDataset(
        raw_cls(data_dir),
        RandomUniformSampler(num_frames, max_num_objects),
        transforms=default_train_transforms(resolution),
        max_num_objects=max_num_objects,
    )
    return TrainMixedVideoLoader([dataset], [batch_size], max_num_objects=max_num_objects, seed=seed,
                                 process_index=process_index, process_count=process_count)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--init_ckpt", default=None, help="SAM2.1/MedSAM2 .pt or native ckpt")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--num_frames", type=int, default=4)
    ap.add_argument("--max_num_objects", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=1, help="videos per process")
    ap.add_argument("--base_lr", type=float, default=5e-5)
    ap.add_argument("--vision_lr", type=float, default=3e-5)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--temporal_loss", default="none",
                    choices=["none", "consistency", "graph", "spectral"])
    ap.add_argument("--temporal_loss_weight", type=float, default=0.5)
    ap.add_argument("--temporal_fusion", default="none",
                    choices=["none", "tce", "gfte", "atsf", "gp"])
    ap.add_argument("--curriculum", default="quantum",
                    choices=["none", "quantum", "aes", "neurospectral"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    import torch

    from us_video_medsam2_tpu_torch.core.config import TemporalFusionConfig, resolve_config, snapshot_config
    from us_video_medsam2_tpu_torch.core.device import resolve_device
    from us_video_medsam2_tpu_torch.parallel import distributed
    from us_video_medsam2_tpu_torch.training.losses import LossConfig
    from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
    from us_video_medsam2_tpu_torch.training.train_step import TrainConfig
    from us_video_medsam2_tpu_torch.training.trainer import Trainer, TrainerConfig

    resolve_device(args.device)  # no card and not --device cpu: raise before anything else
    device = distributed.maybe_initialize_distributed(args.device)

    cfg = resolve_config(args.cfg)
    if args.resolution != cfg.image_size:
        # keep the memory-attention RoPE grid in lockstep with the feature map
        # (reference sam2/modeling/sam/transformer.py:330-333)
        feat = args.resolution // cfg.backbone_stride
        cfg = dataclasses.replace(
            cfg,
            image_size=args.resolution,
            memory_attention=dataclasses.replace(cfg.memory_attention, rope_feat_sizes=(feat, feat)),
        )
    if args.temporal_fusion != "none":
        cfg = dataclasses.replace(
            cfg, temporal_fusion=TemporalFusionConfig(variant=args.temporal_fusion, channels=cfg.hidden_dim))
    model = build_model(cfg, args.init_ckpt)

    loader = make_loader(args.data_dir, args.curriculum, args.num_frames, args.max_num_objects, args.batch_size,
                         cfg.image_size, args.seed, distributed.rank(), distributed.world())
    steps_per_epoch = max(len(loader), 1)
    train_cfg = TrainConfig(
        sim=TrainSimConfig(),
        loss=LossConfig(
            weight_temporal=args.temporal_loss_weight if args.temporal_loss != "none" else 0.0,
            temporal_variant=args.temporal_loss if args.temporal_loss != "none" else "consistency",
        ),
        optim=OptimConfig(
            base_lr=args.base_lr,
            vision_lr=args.vision_lr,
            total_steps=steps_per_epoch * args.epochs,
        ),
    )
    trainer_cfg = TrainerConfig(max_epochs=args.epochs, save_dir=args.out_dir, seed=args.seed)
    if distributed.rank() == 0:
        os.makedirs(args.out_dir, exist_ok=True)
        snapshot_config(cfg, os.path.join(args.out_dir, "config_resolved.json"))
        snapshot_config(train_cfg, os.path.join(args.out_dir, "train_config_resolved.json"))
    distributed.barrier()

    trainer = Trainer(model, train_cfg, trainer_cfg, loader, device=device, dtype=torch.bfloat16)
    best = trainer.run()
    print(f"training done; best {trainer_cfg.best_meter_key}={best:.4f}")
    return trainer


if __name__ == "__main__":
    main()
