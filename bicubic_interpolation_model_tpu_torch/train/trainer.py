"""Training loop for the weight predictor and the train step of the direct
pixel-regression baselines (counterpart of
``bicubic_interpolation_model_tpu/train/trainer.py``).

The reference trains with adam(1e-4), MSE loss on the 16-channel weight
map, MAE metric, batch = one whole image, 100 epochs (train.js:140-240).
A step is one forward, ``loss.backward()`` and an Adam update of the
parameter tree's leaves in place. Two batching modes, as in the JAX
package:

- ``patch`` (default): fixed-size random LR crops batched together;
- ``image``: whole-image batches like the reference, padded to a size
  bucket (multiple of ``bucket``) with a loss mask.

Batches come from ``np.random.default_rng(cfg.seed)`` with the JAX
trainer's draws in its order, so both packages see the same batches.
Initial weights come from a ``torch.Generator`` seeded with ``cfg.seed``
and flax's distributions; JAX's draws themselves cannot be reproduced, so
``fit`` takes a parameter tree of either package.

f32 contract: the JAX package trains in f32, and cuDNN would run f32 convs
as TF32 by default. The forward, the backward (autograd runs the backward
convs at ``loss.backward()``) and the update all run inside
:func:`full_f32`, which also keeps TF32 off for the upsample's ``einsum``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.inference import _device_of
from ..models.layers import init_tree_, tree_from_jax, tree_map
from ..ops.adaptive import adaptive_gt_factors
from ..ops.learned import gt_weight_map, offset_map
from ..runtime.device import conv_precision, full_f32_matmul, resolve_device


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    epochs: int = 100
    mode: str = "patch"          # "patch" | "image"
    patch_lr: int = 64           # LR patch side (HR side = patch_lr * scale)
    batch_size: int = 8
    bucket: int = 64             # LR bucket multiple for image mode
    # image mode: batch up to this many SAME-BUCKET images per step. 1 (the
    # default) reproduces the reference's per-image Adam updates
    # (train.js:174-207); >1 changes the update granularity (batch-mean
    # gradient over the group)
    image_batch: int = 1
    scale: int = 4
    seed: int = 0
    log_every: int = 10
    adaptive_targets: bool = False  # v4.0-style luma-modulated GT weights
    # recompute the forward in the backward pass, segment by segment
    # (torch.utils.checkpoint): whole-image batches keep the SR-resolution
    # activations of every image alive for the backward otherwise
    remat: bool = False


@contextlib.contextmanager
def full_f32():
    """f32 convs and matmuls at full precision (cuDNN and cuBLAS TF32 off:
    ``runtime.device.conv_precision`` and ``full_f32_matmul``) for the
    region, which must hold the forward, the backward and the update; the
    flags are restored on exit."""
    with conv_precision(torch.float32), full_f32_matmul():
        yield


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict in its order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def trainable(tree: dict, device) -> dict:
    """A parameter tree of either package (numpy, jax or torch leaves) as a
    ``{"params": ...}`` tree of fresh float32 leaf tensors on ``device``
    that require grad; the caller's tensors are never updated."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.clone().requires_grad_(True),
                    tree_from_jax(tree, device=dev))


def fresh_params(model, device, seed: int, generator=None) -> dict:
    """``model``'s parameters drawn anew on ``device`` (flax's
    distributions, from ``generator`` or a generator of that device seeded
    with ``seed``) and returned as a :func:`trainable` tree. The module is
    moved to ``device`` and keeps the drawn values too; build a large model
    on the device (``layers.empty_module``) so that nothing is drawn on the
    host first."""
    dev = resolve_device(device)
    model.to(dev)
    g = generator if generator is not None else torch.Generator(
        device=dev).manual_seed(seed)
    init_tree_(model, g)
    return trainable(model.tree(), dev)


class OptState:
    """An optimizer bound to a parameter tree's leaves (the state of
    :class:`Optimizer`) and, for a decaying rate, its schedule, stepped after
    every update."""

    def __init__(self, opt: torch.optim.Optimizer, sched=None):
        self.opt, self.sched = opt, sched

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        self.opt.step()
        if self.sched is not None:
            self.sched.step()

    @property
    def learning_rate(self) -> float:
        """The rate the next update takes."""
        return self.opt.param_groups[0]["lr"]


class Optimizer:
    """The part of an optax ``GradientTransformation`` the trainers use:
    :meth:`init` binds it to a parameter tree, whose leaves each update
    then changes in place."""

    def __init__(self, cls, learning_rate: float, *, decay_steps=None,
                 decay_rate: float = 1.0, **kw):
        self.cls, self.learning_rate, self.kw = cls, learning_rate, kw
        self.decay_steps, self.decay_rate = decay_steps, decay_rate

    def init(self, params) -> OptState:
        opt = self.cls(leaves(params), lr=self.learning_rate, **self.kw)
        if not self.decay_steps:
            return OptState(opt)
        # optax.exponential_decay without staircase: update t (from 0)
        # takes lr * decay_rate ** (t / decay_steps)
        t_per, rate = float(self.decay_steps), self.decay_rate
        return OptState(opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda t: rate ** (t / t_per)))


def adam(learning_rate: float, *, decay_steps=None,
         decay_rate: float = 1.0) -> Optimizer:
    """``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    as torch's), with ``optax.exponential_decay(learning_rate,
    decay_steps, decay_rate)`` when ``decay_steps`` is given."""
    return Optimizer(torch.optim.Adam, learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     betas=(0.9, 0.999), eps=1e-8)


def sgd(learning_rate: float) -> Optimizer:
    """``optax.sgd``: no momentum."""
    return Optimizer(torch.optim.SGD, learning_rate)


def on_device(arr, dev) -> torch.Tensor:
    """A batch array (numpy or tensor) as a float32 tensor on ``dev``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(dev, torch.float32)
    a = np.ascontiguousarray(arr, np.float32)
    # a read-only view (a broadcast target tile) is copied, never aliased
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)


def adaptive_targets(img: torch.Tensor, y: torch.Tensor,
                     scale: int) -> torch.Tensor:
    """GT weights modulated per image by the v4.0 luma-contrast factors
    (``ops.adaptive.adaptive_gt_factors``) and renormalised. The standard
    (normalised) base tile works as ``y``: normalize(normalize(g)*f) ==
    normalize(g*f)."""
    factors = torch.stack([adaptive_gt_factors(im, scale, device=im.device)
                           for im in img])
    w = y * factors
    s = w.sum(dim=-1, keepdim=True)
    return torch.where(s > 0, w / s, torch.zeros_like(w))


def masked_losses(pred, target, mask):
    """(MSE, MAE) over the mask's pixels: sums over
    ``max(mask.sum() * channels, 1)`` (trainer.py:75-81)."""
    err = (pred - target) * mask
    denom = torch.clamp(mask.sum() * target.shape[-1], min=1.0)
    return (err * err).sum() / denom, err.abs().sum() / denom


def make_weight_predictor_step(model, *, adaptive: bool = False,
                               scale: int = 4, remat: bool = False):
    """``step(params, opt_state, img, off, y, mask) -> (params, opt_state,
    loss, mae)``: one forward, backward and update of the tree in place
    (``opt_state`` from :meth:`Optimizer.init` on ``params``); the batch
    (numpy or tensors) moves to the parameters' device.

    With ``adaptive`` the GT target is modulated inside the step by the
    per-tap luma-contrast factors of v4.0, per image. With ``remat`` each
    of the forward's segments (``weight_predictor.forward_params``) is
    recomputed in the backward pass on its own, so the backward holds one
    segment's SR-resolution activations at a time, not the whole
    forward's."""

    def segment(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False)

    def forward(params, img, off):
        if remat:
            return model.apply(params, img, off, run=segment)
        return model.apply(params, img, off)

    def step(params, opt_state, img, off, y, mask):
        dev = _device_of(params)
        img, off, y, mask = (on_device(a, dev) for a in (img, off, y, mask))
        with full_f32():
            if adaptive:
                y = adaptive_targets(img, y, scale)
            opt_state.zero_grad()
            loss, mae = masked_losses(forward(params, img, off), y, mask)
            # a reported metric: its graph would keep the SR-resolution
            # error map alive through the whole backward
            mae = mae.detach()
            loss.backward()
            opt_state.step()
        return params, opt_state, loss.detach(), mae

    return step


def make_direct_sr_step(model):
    """``step(params, opt_state, lr, hr) -> (params, opt_state, loss,
    mae)`` for (lr, hr) pixel-regression models (the ESPCN family): MSE
    and MAE over every element."""

    def step(params, opt_state, lr, hr):
        dev = _device_of(params)
        lr, hr = on_device(lr, dev), on_device(hr, dev)
        with full_f32():
            opt_state.zero_grad()
            err = model.apply(params, lr) - hr
            loss = (err * err).mean()
            loss.backward()
            opt_state.step()
        return params, opt_state, loss.detach(), err.detach().abs().mean()

    return step


def _pad_to(arr, h, w):
    ph, pw = h - arr.shape[0], w - arr.shape[1]
    return np.pad(arr, ((0, ph), (0, pw), (0, 0)))


def _bucket(n, m):
    return -(-n // m) * m


def _stack(arrays):
    if isinstance(arrays[0], torch.Tensor):
        return torch.stack(arrays)
    return np.stack(arrays)


class WeightPredictorTrainer:
    """Drives training over a dataset of (X, offset, Y) triplets keyed by id
    (``data.binfmt.load_triplets``), or of X alone
    (``data.onthefly.load_hr_dir``), on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, model, config: TrainConfig | None = None, *,
                 device="cuda"):
        self.model = model
        self.cfg = config or TrainConfig()
        self.device = resolve_device(device)
        self.optimizer = adam(self.cfg.learning_rate)
        self.step_fn = make_weight_predictor_step(
            self.model, adaptive=self.cfg.adaptive_targets,
            scale=self.cfg.scale, remat=self.cfg.remat)
        self.history: list[dict] = []

    def init_params(self, generator=None) -> dict:
        """Fresh parameters on the trainer's device (:func:`fresh_params`)."""
        return fresh_params(self.model, self.device, self.cfg.seed,
                            generator)

    # ---- batch construction -------------------------------------------------

    def _patch_batches(self, data, rng):
        cfg = self.cfg
        s = cfg.scale
        p = cfg.patch_lr
        ids = [k for k, v in data.items() if v["X"].shape[0] >= p
               and v["X"].shape[1] >= p]
        if not ids:
            raise ValueError(f"no sample is >= {p}x{p} LR pixels")
        # stored-target datasets only; Y-less datasets route through
        # _synth_patch_batches (see fit())
        for _ in range(max(1, len(ids))):
            imgs, offs, ys = [], [], []
            for _ in range(cfg.batch_size):
                d = data[ids[rng.integers(len(ids))]]
                h, w = d["X"].shape[:2]
                y0 = int(rng.integers(h - p + 1))
                x0 = int(rng.integers(w - p + 1))
                imgs.append(d["X"][y0:y0 + p, x0:x0 + p])
                offs.append(d["offset"][y0 * s:(y0 + p) * s,
                                        x0 * s:(x0 + p) * s])
                ys.append(d["Y"][y0 * s:(y0 + p) * s, x0 * s:(x0 + p) * s])
            mask = np.ones((cfg.batch_size, p * s, p * s, 1), np.float32)
            yield (np.stack(imgs), np.stack(offs), np.stack(ys), mask)

    def _image_batches(self, data):
        cfg = self.cfg
        s = cfg.scale
        nb = max(1, cfg.image_batch)

        # Y-less datasets: both target maps are S-periodic in each axis, so
        # one synthesised map per padded bucket geometry is exact for every
        # image in the bucket (pad regions are masked out of the loss); it
        # stays on the trainer's device
        synth_cache: dict[tuple[int, int], tuple] = {}

        def targets(d, hb, wb):
            if "offset" in d and "Y" in d:
                return (_pad_to(d["offset"], hb * s, wb * s),
                        _pad_to(d["Y"], hb * s, wb * s))
            key = (hb, wb)
            if key not in synth_cache:
                synth_cache[key] = (
                    offset_map(hb * s, wb * s, float(s), "train",
                               device=self.device),
                    gt_weight_map(hb * s, wb * s, float(s),
                                  device=self.device))
            return synth_cache[key]

        if nb == 1:
            # one image per step in insertion order, so per-image Adam
            # updates land in the reference's sequence (train.js:174-207)
            for sid, d in data.items():
                h, w = d["X"].shape[:2]
                hb, wb = _bucket(h, cfg.bucket), _bucket(w, cfg.bucket)
                m = np.zeros((hb * s, wb * s, 1), np.float32)
                m[:h * s, :w * s] = 1.0
                off, y = targets(d, hb, wb)
                yield (_pad_to(d["X"], hb, wb)[None], off[None], y[None],
                       m[None])
            return
        # group by bucketed LR shape so grouped images share one geometry
        groups: dict[tuple[int, int], list] = {}
        order: list[tuple[int, int]] = []
        for sid, d in data.items():
            h, w = d["X"].shape[:2]
            key = (_bucket(h, cfg.bucket), _bucket(w, cfg.bucket))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(d)
        for key in order:
            hb, wb = key
            members = groups[key]
            for i in range(0, len(members), nb):
                chunk = members[i:i + nb]
                imgs, offs, ys, masks = [], [], [], []
                for d in chunk:
                    h, w = d["X"].shape[:2]
                    imgs.append(_pad_to(d["X"], hb, wb))
                    off, y = targets(d, hb, wb)
                    offs.append(off)
                    ys.append(y)
                    m = np.zeros((hb * s, wb * s, 1), np.float32)
                    m[:h * s, :w * s] = 1.0
                    masks.append(m)
                # ragged tail groups pad with a zero-mask repeat of the last
                # image so every group in a bucket has one shape (only when
                # a full group exists — a lone undersized bucket keeps its
                # natural batch)
                while nb > 1 and i > 0 and len(imgs) < nb:
                    imgs.append(imgs[-1])
                    offs.append(offs[-1])
                    ys.append(ys[-1])
                    masks.append(np.zeros_like(masks[-1]))
                yield (np.stack(imgs), _stack(offs), _stack(ys),
                       np.stack(masks))

    def _synth_patch_batches(self, data, rng, device_targets):
        """Patch batches when offset/Y are synthesised: only the images move
        host→device; the (identical) target tiles stay on the device."""
        cfg = self.cfg
        p = cfg.patch_lr
        off_b, y_b, mask_b = device_targets
        ids = [k for k, v in data.items() if v["X"].shape[0] >= p
               and v["X"].shape[1] >= p]
        if not ids:
            raise ValueError(f"no sample is >= {p}x{p} LR pixels")
        for _ in range(max(1, len(ids))):
            imgs = []
            for _ in range(cfg.batch_size):
                d = data[ids[rng.integers(len(ids))]]
                h, w = d["X"].shape[:2]
                y0 = int(rng.integers(h - p + 1))
                x0 = int(rng.integers(w - p + 1))
                imgs.append(d["X"][y0:y0 + p, x0:x0 + p])
            yield (np.stack(imgs), off_b, y_b, mask_b)

    def device_targets(self):
        """The synthesised patch targets (offsets, Y, mask) of one batch on
        the trainer's device."""
        from ..data.onthefly import target_tiles

        cfg = self.cfg
        off_tile, y_tile = target_tiles(cfg.patch_lr, cfg.scale,
                                        device=self.device)
        b = cfg.batch_size
        n = cfg.patch_lr * cfg.scale
        return (off_tile[None].expand(b, n, n, 2).contiguous(),
                y_tile[None].expand(b, n, n, 16).contiguous(),
                torch.ones((b, n, n, 1), device=self.device))

    # ---- main loop ----------------------------------------------------------

    def fit(self, data: dict[str, dict[str, np.ndarray]], params=None,
            epochs: int | None = None, log=print):
        """Train and return the parameter tree (float32 tensors on the
        trainer's device). ``params`` is a tree of either package, copied
        before training; by default :meth:`init_params`."""
        cfg = self.cfg
        params = (trainable(params, self.device) if params is not None
                  else self.init_params())
        opt_state = self.optimizer.init(params)
        rng = np.random.default_rng(cfg.seed)
        epochs = epochs if epochs is not None else cfg.epochs

        synth = cfg.mode == "patch" and any(
            "Y" not in v for v in data.values())
        device_targets = self.device_targets() if synth else None

        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses, maes = [], []
            if synth:
                batches = self._synth_patch_batches(data, rng, device_targets)
            elif cfg.mode == "patch":
                batches = self._patch_batches(data, rng)
            else:
                batches = self._image_batches(data)
            for bi, (img, off, y, mask) in enumerate(batches):
                params, opt_state, loss, mae = self.step_fn(
                    params, opt_state, img, off, y, mask)
                losses.append(float(loss))
                maes.append(float(mae))
                if (bi + 1) % cfg.log_every == 0:
                    log(f"epoch {epoch + 1} batch {bi + 1}: "
                        f"loss={losses[-1]:.8f} mae={maes[-1]:.8f}")
            rec = {"epoch": epoch + 1,
                   "loss": float(np.mean(losses)),
                   "mae": float(np.mean(maes)),
                   "seconds": time.perf_counter() - t0}
            self.history.append(rec)
            log(f"epoch {rec['epoch']}/{epochs}: loss={rec['loss']:.8f} "
                f"mae={rec['mae']:.8f} ({rec['seconds']:.2f}s)")
        return params
