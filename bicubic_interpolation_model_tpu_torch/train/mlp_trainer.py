"""Trainer for the v2.0-style per-pixel MLP (counterpart of
``bicubic_interpolation_model_tpu/train/mlp_trainer.py``): SGD, MSE,
max-norm kernel constraint after each step, early stopping with patience 5
(version2.0/utils/train.js:54-90, :124-149)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.mlp_predictor import apply_max_norm
from ..runtime.device import resolve_device
from .trainer import fresh_params, full_f32, leaves, sgd, trainable


@dataclasses.dataclass
class MLPTrainConfig:
    learning_rate: float = 0.01
    epochs: int = 100
    batch_size: int = 8192
    max_norm: float = 3.0
    patience: int = 5          # early stopping (v2 train.js:124-149)
    min_delta: float = 1e-7
    seed: int = 0


def make_mlp_step(model, max_norm: float):
    """``step(params, opt_state, x, y) -> (params, opt_state, loss)``: one
    SGD update of the tree in place, then the max-norm constraint."""

    def step(params, opt_state, x, y):
        with full_f32():
            opt_state.zero_grad()
            loss = ((model.apply(params, x) - y) ** 2).mean()
            loss.backward()
            opt_state.step()
            with torch.no_grad():
                for t, c in zip(leaves(params),
                                leaves(apply_max_norm(params, max_norm))):
                    t.copy_(c)
        return params, opt_state, loss.detach()

    return step


def train_pixel_mlp(model, features: np.ndarray, targets: np.ndarray,
                    cfg: MLPTrainConfig | None = None, log=print, *,
                    params=None, device="cuda"):
    """features [N, F], targets [N, 16] → ``(params, history)``: the trained
    tree (float32 tensors on ``device``, the card unless the caller passes
    ``device="cpu"``) and the mean loss per epoch. ``params`` (a tree of
    either package, copied) replaces the fresh draw from ``cfg.seed``."""
    cfg = cfg or MLPTrainConfig()
    dev = resolve_device(device)
    n = features.shape[0]
    if n == 0:
        raise ValueError("empty feature set")
    if params is None:
        params = fresh_params(model, dev, cfg.seed)
        n_in = leaves(params)[0].shape[0]
        if n_in != features.shape[1]:
            raise ValueError(f"the model takes {n_in} features, the set has "
                             f"{features.shape[1]}")
    else:
        params = trainable(params, dev)
    opt_state = sgd(cfg.learning_rate).init(params)
    step = make_mlp_step(model, cfg.max_norm)
    x_all = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
    y_all = torch.from_numpy(np.ascontiguousarray(targets, np.float32)).to(dev)

    rng = np.random.default_rng(cfg.seed)
    batch = min(cfg.batch_size, n)
    best = np.inf
    stale = 0
    history = []
    for epoch in range(cfg.epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        for i in range(0, n - batch + 1, batch):
            idx = order[i:i + batch]
            params, opt_state, loss = step(params, opt_state, x_all[idx],
                                           y_all[idx])
            losses.append(float(loss))
        avg = float(np.mean(losses)) if losses else np.inf
        history.append(avg)
        log(f"epoch {epoch + 1}: loss={avg:.8f}")
        if avg < best - cfg.min_delta:
            best = avg
            stale = 0
        else:
            stale += 1
            if stale >= cfg.patience:
                log(f"early stop at epoch {epoch + 1} (patience {cfg.patience})")
                break
    return params, history
