"""Training loop: epochs, meters, logging, checkpoints, resume, best-checkpoint tracking.

Counterpart of the JAX package's ``training/trainer.py`` (reference
training/trainer.py:141-1106). Kept from it: the epochs and their meters,
the NaN guard (reference trainer.py:865-871), the per-epoch curriculum stage
through the loader, optional TensorBoard, ``train_stats.json`` and
``best_stats.json`` with the JAX keys, ``best_checkpoint``, ``save_freq``
and ``save_epochs``, a checkpoint and ``SystemExit(0)`` at the next
iteration after a pre-emption signal, auto-resume from
``<save_dir>/checkpoint.npz``, the validation epoch through
``make_eval_step`` and the epoch's ETA in the log.

Where it differs from the JAX trainer:
- each step draws its plan and noise from a ``torch.Generator`` seeded from
  the seed, the epoch and the iteration (the JAX trainer splits a
  ``jax.random`` key); every rank seeds it alike;
- a batch reaches the card through page-locked memory and non-blocking
  copies;
- data parallelism is ``parallel/distributed.py``'s (``train_step.py``
  reduces the object count and the gradients); rank 0 alone writes files;
- checkpoints hold the f32 master weights in the JAX tree's names
  (``core/weights.py::to_jax_params``) and the optimizer in the JAX layout,
  so either package's trainer resumes the other's and either package's
  ``core/build.py::load_params`` serves them.

``step_times`` keeps each step's (data s, step s): the host's wait for the
loader's batch and the step up to its loss on the host; ``save_times`` each
checkpoint write's seconds (rank 0).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from us_video_medsam2_tpu_torch.core import checkpoint as ckpt_lib
from us_video_medsam2_tpu_torch.core.weights import from_jax_params, to_jax_params
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.parallel import distributed
from us_video_medsam2_tpu_torch.training.data import TrainMixedVideoLoader
from us_video_medsam2_tpu_torch.training.train_step import (
    TrainBatch,
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from us_video_medsam2_tpu_torch.utils.metrics import AverageMeter, DurationMeter, MemMeter


@dataclass
class TrainerConfig:
    max_epochs: int = 100
    save_dir: str = "work_dir"
    save_freq: int = 10
    save_epochs: List[int] = field(default_factory=list)  # extra named checkpoints
    log_freq: int = 10
    seed: int = 0
    val_epoch_freq: int = 1
    best_meter_key: str = "core_loss"  # lower is better
    skip_saving_parameters: List[str] = field(default_factory=list)
    # 'npz' only: the JAX package's 'orbax' backend is not ported and raises
    checkpoint_backend: str = "npz"
    # checkpoint-and-exit on these signals (pre-emption: a requeued job
    # resumes from the checkpoint, reference training/train.py:65-111)
    checkpoint_signals: tuple = (signal.SIGTERM, signal.SIGUSR1)


def step_generator(seed: int, epoch: int, it: int) -> torch.Generator:
    """The CPU generator of iteration ``it`` of ``epoch``: the step's plan,
    noise seed and dropout seeds."""
    return torch.Generator().manual_seed((seed * 1_000_003 + epoch) * 100_003 + it)


class Trainer:
    LOSS_KEYS = (
        "core_loss", "loss_mask", "loss_dice", "loss_iou", "loss_class",
        "loss_temporal", "grad_norm",
    )

    def __init__(
        self,
        model: SAM2Model,
        train_cfg: TrainConfig,
        trainer_cfg: TrainerConfig,
        train_loader: TrainMixedVideoLoader,
        val_loader: Optional[TrainMixedVideoLoader] = None,
        device: str | torch.device = "cuda",
        dtype: torch.dtype = torch.bfloat16,
    ):
        if trainer_cfg.checkpoint_backend != "npz":
            raise NotImplementedError(f"checkpoint_backend={trainer_cfg.checkpoint_backend!r}: the port writes "
                                      "the npz backend only (the JAX package's Orbax backend is not ported)")
        self.cfg = trainer_cfg
        self.train_cfg = train_cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.model_cfg = model.cfg
        self.state = create_train_state(model, train_cfg, device, dtype)
        self.model = self.state.model
        self.device = next(self.model.parameters()).device
        self.step_fn = make_train_step(train_cfg)
        self._eval_step = None
        self.rank = distributed.rank()
        self.epoch = 0
        self.best = float("inf")
        self.step_times: List[tuple] = []
        self.save_times: List[float] = []
        self.time_meter = DurationMeter()
        self.mem_meter = MemMeter()
        if self.rank == 0:
            os.makedirs(self.cfg.save_dir, exist_ok=True)
        self.tb = self._make_tb_writer()
        self._maybe_resume()
        self._preempted = False
        for sig in self.cfg.checkpoint_signals:
            try:
                signal.signal(sig, self._on_preempt_signal)
            except ValueError:  # not on the main thread (e.g. inside a test runner)
                pass

    def _on_preempt_signal(self, signum, frame):
        logging.warning("received signal %d: will checkpoint and exit", signum)
        self._preempted = True

    def _make_tb_writer(self):
        """Rank 0's TensorBoard writer, where TensorBoard is installed
        (reference training/utils/logger.py:27-150)."""
        if self.rank != 0:
            return None
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(log_dir=os.path.join(self.cfg.save_dir, "tensorboard"), flush_secs=120)
        except Exception:  # noqa: BLE001
            return None

    # ----------------------------------------------------------- persistence
    def checkpoint_state(self) -> Dict:
        """The checkpoint tree in the JAX trainer's layout: ``params`` (JAX
        variables, f32 master weights and BatchNorm statistics),
        ``opt_state``, ``step``, ``epoch``, ``best``."""
        sd = self.model.state_dict()
        buffers = dict(self.model.named_buffers())
        return {
            "params": to_jax_params(sd, self.model_cfg),
            "opt_state": self.state.optimizer.state_dict(self.model_cfg, buffers),
            "step": np.asarray(self.state.step, np.int32),
            "epoch": np.asarray(self.epoch, np.int64),
            "best": np.asarray(self.best, np.float64),
        }

    def save_checkpoint(self, name="checkpoint"):
        """``<save_dir>/<name>.npz`` and its ``.meta.json``, from rank 0;
        every rank waits for it."""
        if self.rank == 0:
            t0 = time.perf_counter()
            path = os.path.join(self.cfg.save_dir, name)
            ckpt_lib.save_checkpoint_any(path, self.checkpoint_state(),
                                         skip_patterns=[f"params/{p}" for p in self.cfg.skip_saving_parameters],
                                         backend=self.cfg.checkpoint_backend)
            self.save_times.append(time.perf_counter() - t0)
            logging.info("saved checkpoint %s in %.2f s", path, self.save_times[-1])
        distributed.barrier()

    @torch.no_grad()
    def _maybe_resume(self):
        resume = ckpt_lib.get_resume_checkpoint(self.cfg.save_dir)
        if resume is None:
            return
        loaded = ckpt_lib.restore_checkpoint(resume)
        sd = from_jax_params(loaded["params"], self.model_cfg)
        self.model.load_state_dict(sd, strict=True)
        self.state.optimizer.load_state_dict(loaded["opt_state"])
        self.state.step = int(np.asarray(loaded["step"]))
        self.epoch = int(np.asarray(loaded.get("epoch", 0)))
        self.best = float(np.asarray(loaded.get("best", float("inf"))))
        logging.info("resumed from %s at epoch %d (step %d, best %s)", resume, self.epoch, self.state.step,
                     self.best)

    # ------------------------------------------------------------------ loops
    def to_device(self, batch: Dict) -> TrainBatch:
        """The host batch on the training device: through page-locked memory
        and non-blocking copies on the card."""
        def move(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self.device.type != "cuda":
                return t
            return t.pin_memory().to(self.device, non_blocking=True)

        return TrainBatch(move(batch["images"]), move(batch["masks"]), move(batch["obj_valid"]))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        meters: Dict[str, AverageMeter] = {}
        data_time = AverageMeter("data_time")
        batch_time = AverageMeter("batch_time")
        # the residual dropouts draw from torch's global generators: seeded by
        # the epoch (and the rank: each draws for its own rows), an epoch is
        # the same in a resumed run as in an uninterrupted one
        torch.manual_seed((self.cfg.seed * 1_000_003 + epoch) * 1_009 + self.rank)
        t_last = time.monotonic()
        for it, batch in enumerate(self.train_loader.get_loader(epoch)):
            t_data = time.monotonic()
            data_time.update(t_data - t_last)
            metrics = self.step_fn(self.state, self.to_device(batch), step_generator(self.cfg.seed, epoch, it))
            core = float(metrics["core_loss"])
            if not np.isfinite(core):
                raise FloatingPointError(f"loss is {core} at epoch {epoch} iter {it}")  # NaN guard
            for k in self.LOSS_KEYS:
                if k in metrics:
                    meters.setdefault(k, AverageMeter(k)).update(float(metrics[k]))
            if self.tb is not None and it % self.cfg.log_freq == 0:
                self.tb.add_scalar("Losses/train_all_loss", core, self.state.step)
                for k in ("loss_mask", "loss_dice", "loss_iou", "loss_class", "loss_temporal"):
                    if k in metrics:
                        self.tb.add_scalar(f"Losses/{k}", float(metrics[k]), self.state.step)
            t_now = time.monotonic()
            self.step_times.append((t_data - t_last, t_now - t_data))
            batch_time.update(t_now - t_last)
            t_last = t_now
            self.mem_meter.update()
            if it % self.cfg.log_freq == 0:
                logging.info("epoch %d it %d | loss %.4f | %s | %s | peak %.2f GiB", epoch, it, core, batch_time,
                             data_time, self.mem_meter.peak_gib)
            if self._preempted:
                self.save_checkpoint()
                logging.warning("preemption checkpoint at epoch %d iter %d; exiting", epoch, it)
                raise SystemExit(0)
        return {k: m.avg for k, m in meters.items()}

    def val_epoch(self, epoch: int) -> Dict[str, float]:
        if self.val_loader is None:
            return {}
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.train_cfg)
        meter = AverageMeter("val_core_loss")
        for it, batch in enumerate(self.val_loader.get_loader(epoch)):
            losses = self._eval_step(self.model, self.to_device(batch), step_generator(7777, epoch, it))
            meter.update(float(losses["core_loss"]))
        logging.info("epoch %d val loss %.4f", epoch, meter.avg)
        return {"val_core_loss": meter.avg}

    def _append(self, path: str, record: dict) -> None:
        if self.rank == 0:
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def run(self) -> float:
        stats_path = os.path.join(self.cfg.save_dir, "train_stats.json")
        best_path = os.path.join(self.cfg.save_dir, "best_stats.json")
        start_epoch = self.epoch
        while self.epoch < self.cfg.max_epochs:
            epoch = self.epoch
            stats = self.train_epoch(epoch)
            if "core_loss" not in stats:
                raise RuntimeError(
                    f"epoch {epoch} produced no batches — check dataset size "
                    "vs batch size and curriculum stage filters"
                )
            self.time_meter.update()
            record = {
                "epoch": epoch,
                "Losses/train_all_loss": stats["core_loss"],
                "steps": int(self.state.step),
                "time_elapsed": self.time_meter.elapsed,
            }
            record.update({f"Losses/{k}": v for k, v in stats.items() if k != "core_loss"})
            if self.val_loader is not None and epoch % self.cfg.val_epoch_freq == 0:
                record.update(self.val_epoch(epoch))
            self._append(stats_path, record)
            if stats[self.cfg.best_meter_key] < self.best:
                self.best = stats[self.cfg.best_meter_key]
                self.save_checkpoint("best_checkpoint")
                self._append(best_path, record)
            self.epoch += 1
            if self.cfg.save_freq and epoch % self.cfg.save_freq == 0:
                self.save_checkpoint()
            if epoch in self.cfg.save_epochs:  # epoch-list checkpoints
                self.save_checkpoint(f"checkpoint_epoch_{epoch}")
            done_frac = (epoch + 1 - start_epoch) / max(self.cfg.max_epochs - start_epoch, 1)
            eta = self.time_meter.elapsed * (1.0 / done_frac - 1.0)
            logging.info("epoch %d done | loss %.4f | elapsed %.0fs | ETA %.0fs", epoch, stats["core_loss"],
                         self.time_meter.elapsed, eta)
        self.save_checkpoint()
        return self.best
