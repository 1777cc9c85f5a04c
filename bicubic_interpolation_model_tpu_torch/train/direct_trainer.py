"""Trainer for the direct pixel-regression SR models of
``models.zoo.MODEL_ZOO`` (counterpart of
``bicubic_interpolation_model_tpu/train/direct_trainer.py``): random LR/HR
patch pairs, Adam with exponential decay, MSE in [0, 1] pixel space."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..runtime.device import resolve_device
from .trainer import adam, fresh_params, make_direct_sr_step, trainable


@dataclasses.dataclass
class DirectSRConfig:
    learning_rate: float = 1e-3
    epochs: int = 50
    steps_per_epoch: int = 50
    patch_lr: int = 32
    batch_size: int = 16
    scale: int = 4
    channels: int = 3
    seed: int = 0
    lr_decay: float = 0.97
    # 8-fold dihedral augmentation (rot90 × flip) of each LR/HR patch pair;
    # default False so older checkpoints stay reproducible from their
    # meta.json configs
    augment: bool = False


class DirectSRTrainer:
    """Trains ``model`` (a ``MODEL_ZOO`` module) on ``device`` (the card
    unless the caller passes ``device="cpu"``). Build a large model on that
    device (``models.layers.empty_module``): :meth:`init_params` draws its
    weights there."""

    def __init__(self, model, config: DirectSRConfig | None = None, *,
                 device="cuda"):
        self.model = model
        self.cfg = config or DirectSRConfig()
        self.device = resolve_device(device)
        self.optimizer = adam(self.cfg.learning_rate,
                              decay_steps=self.cfg.steps_per_epoch,
                              decay_rate=self.cfg.lr_decay)
        self.step_fn = make_direct_sr_step(self.model)
        self.history: list[dict] = []

    def init_params(self, generator=None) -> dict:
        """Fresh parameters on the trainer's device
        (``trainer.fresh_params``)."""
        return fresh_params(self.model, self.device, self.cfg.seed,
                            generator)

    def _batch(self, data, ids, rng):
        cfg = self.cfg
        s, p, c = cfg.scale, cfg.patch_lr, cfg.channels
        lrs, hrs = [], []
        for _ in range(cfg.batch_size):
            d = data[ids[rng.integers(len(ids))]]
            h, w = d["X"].shape[:2]
            y0 = int(rng.integers(h - p + 1))
            x0 = int(rng.integers(w - p + 1))
            lr = d["X"][y0:y0 + p, x0:x0 + p, :c]
            hr = (d["HR"][y0 * s:(y0 + p) * s, x0 * s:(x0 + p) * s, :c]
                  .astype(np.float32) / 255.0)
            if cfg.augment:
                k = int(rng.integers(4))
                if k:
                    lr, hr = np.rot90(lr, k), np.rot90(hr, k)
                if rng.integers(2):
                    lr, hr = lr[:, ::-1], hr[:, ::-1]
            lrs.append(np.ascontiguousarray(lr))
            hrs.append(np.ascontiguousarray(hr))
        return np.stack(lrs), np.stack(hrs)

    def fit(self, data, params=None, epochs=None, log=print):
        """Train and return the parameter tree (float32 tensors on the
        trainer's device); ``params`` is a tree of either package, copied
        before training."""
        cfg = self.cfg
        params = (trainable(params, self.device) if params is not None
                  else self.init_params())
        opt_state = self.optimizer.init(params)
        rng = np.random.default_rng(cfg.seed)
        ids = [k for k, v in data.items()
               if "HR" in v and v["X"].shape[0] >= cfg.patch_lr
               and v["X"].shape[1] >= cfg.patch_lr]
        if not ids:
            raise ValueError("need samples with HR kept (keep_hr=True)")
        epochs = epochs if epochs is not None else cfg.epochs
        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses = []
            for _ in range(cfg.steps_per_epoch):
                lr_b, hr_b = self._batch(data, ids, rng)
                params, opt_state, loss, mae = self.step_fn(
                    params, opt_state, lr_b, hr_b)
                losses.append(float(loss))
            rec = {"epoch": epoch + 1, "loss": float(np.mean(losses)),
                   "seconds": time.perf_counter() - t0}
            self.history.append(rec)
            log(f"epoch {rec['epoch']}/{epochs}: loss={rec['loss']:.6f} "
                f"({rec['seconds']:.1f}s)")
        return params
