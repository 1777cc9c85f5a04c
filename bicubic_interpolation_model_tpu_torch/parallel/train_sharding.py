"""Data x spatial parallel train steps over a :class:`.mesh.Mesh`
(counterpart of ``bicubic_interpolation_model_tpu/parallel/
train_sharding.py``).

Layout, as the JAX package's GSPMD program has it:

- batches [B, H, W, C]: B over the ``data`` axis, H over the ``spatial``
  axis; shard (d, s) lives on ``mesh.devices[d, s]``;
- parameters and optimizer state: one copy per distinct device of the mesh
  (a mesh that repeats a card holds one);
- loss and gradients: summed over the shards.

Where XLA's spatial partitioner exchanges conv halos, a band here holds
its rows plus the real rows around them that the model's receptive field
reaches (:func:`receptive_halo`), cut at the true image, so that every conv
pads with zeros exactly where the unsharded step does. Each band's loss
terms count its own rows only, against the global denominator; each
band's backward adds its gradient into its device's copy, the copies' sums
are added together and written back to each, and every copy takes the
same update. The loss and the gradients are the unsharded step's up to
f32 reordering (tests/test_torch_train_sharding.py).
"""

from __future__ import annotations

import dataclasses

from ..models.layers import Conv
from ..train.trainer import full_f32, leaves, on_device, trainable
from .mesh import Mesh


def receptive_halo(model) -> int:
    """LR rows a band needs beyond its own on each side: the kernel radii
    of every conv in the model summed, each counted as if it ran at LR
    (the longest chain of a sequential, residual or dense conv stack; a
    conv at a finer grid reaches fewer LR rows, so this is an upper
    bound). The WeightPredictor gives 3 (conv_in, conv_res, conv_out)."""
    return sum(m.kernel.shape[0] // 2 for m in model.modules()
               if isinstance(m, Conv))


@dataclasses.dataclass
class ShardedArray:
    """An array cut into a (data x spatial) grid of windows: ``windows[d][s]``
    holds shard (d, s)'s rows plus up to ``halo`` real rows each side on
    its device, and ``own[d][s]`` the slice of its own rows inside that
    window."""
    windows: list
    own: list

    def own_rows(self):
        """Each shard's own rows (views of its window), in grid order."""
        return [w[:, o] for row_w, row_o in zip(self.windows, self.own)
                for w, o in zip(row_w, row_o)]


def _shard(arr, mesh: Mesh, data_axis, spatial_axis, halo: int) -> ShardedArray:
    grid = mesh.devices
    if mesh.axis_names.index(data_axis) != 0:
        grid = grid.T
    nd, ns = grid.shape
    b, h = arr.shape[:2]
    if b % nd or h % ns:
        raise ValueError(f"batch {tuple(arr.shape)} does not split over a "
                         f"{nd} x {ns} (data x spatial) mesh")
    bb, hb = b // nd, h // ns
    windows, own = [], []
    for d in range(nd):
        row_w, row_o = [], []
        for s in range(ns):
            lo, hi = max(0, s * hb - halo), min(h, (s + 1) * hb + halo)
            row_w.append(on_device(arr[d * bb:(d + 1) * bb, lo:hi],
                                   grid[d, s]))
            row_o.append(slice(s * hb - lo, s * hb - lo + hb))
        windows.append(row_w)
        own.append(row_o)
    return ShardedArray(windows, own)


def _shard_fn(model, mesh, data_axis, spatial_axis):
    halo = receptive_halo(model)

    def shard_batch(*arrays):
        """Each array sharded B over ``data``, H over ``spatial``; the first
        is the LR input, and every array's halo is the model's LR halo in
        its own rows."""
        h_lr = arrays[0].shape[1]
        return tuple(_shard(a, mesh, data_axis, spatial_axis,
                            halo * (a.shape[1] // h_lr)) for a in arrays)

    return shard_batch


def _replicate_fn(mesh):
    def replicate(tree):
        """A trainable copy of ``tree`` on each distinct device of the mesh,
        keyed by the name of the device its tensors lie on."""
        copies = [trainable(tree, d) for d in dict.fromkeys(mesh.devices.flat)]
        return {str(leaves(c)[0].device): c for c in copies}
    return replicate


def _cells(batch: ShardedArray):
    for d, row in enumerate(batch.windows):
        for s, win in enumerate(row):
            yield d, s, win


def _all_reduce_grads(params: dict):
    """Every copy's gradient set to the sum of all copies' gradients."""
    copies = [leaves(p) for p in params.values()]
    if len(copies) == 1:
        return
    for group in zip(*copies):
        total = sum(t.grad.to(group[0].device) for t in group)
        for t in group:
            t.grad.copy_(total.to(t.device))


def _run(params, opt_state, band_losses):
    """Zero the grads, backward each band's loss term on its device's copy,
    sum the gradients over the copies and update; returns the loss, the
    terms summed over the bands, on the first band's device."""
    with full_f32():
        opt_state.zero_grad()
        loss = None
        for term in band_losses():
            term.backward()
            t = term.detach()
            loss = t if loss is None else loss + t.to(loss.device)
        _all_reduce_grads(params)
        opt_state.step()
    return loss


def make_sharded_train_step(model, mesh: Mesh, data_axis: str = "data",
                            spatial_axis: str = "spatial"):
    """``(step, shard_batch, replicate)`` for the weight-predictor step:
    ``step(params, opt_state, img, off, y, mask) -> (params, opt_state,
    loss)`` with ``params = replicate(tree)``, ``opt_state =
    Optimizer.init(params)`` and the batch from ``shard_batch(img, off, y,
    mask)``. The loss is the masked weight-map MSE of the unsharded step,
    over ``max(mask.sum() * 16, 1)``."""

    def step(params, opt_state, img, off, y, mask):
        denom = max(sum(float(m.sum()) for m in mask.own_rows())
                    * y.windows[0][0].shape[-1], 1.0)

        def band_losses():
            for d, s, win in _cells(img):
                o = y.own[d][s]
                pred = model.apply(params[str(win.device)], win,
                                   off.windows[d][s])[:, o]
                err = (pred - y.windows[d][s][:, o]) * mask.windows[d][s][:, o]
                yield (err * err).sum() / denom

        return params, opt_state, _run(params, opt_state, band_losses)

    return (step, _shard_fn(model, mesh, data_axis, spatial_axis),
            _replicate_fn(mesh))


def make_sharded_direct_step(model, mesh: Mesh, data_axis: str = "data",
                             spatial_axis: str = "spatial"):
    """``(step, shard_batch, replicate)`` for the direct pixel-regression
    family (ESPCN, ESRGANLite, SRResNetTPU): ``step(params, opt_state, lr,
    hr) -> (params, opt_state, loss)`` with the batch from
    ``shard_batch(lr, hr)``; the loss is the MSE over every element of
    ``hr``. A band's halo is :func:`receptive_halo` of the model's conv
    stack."""

    def step(params, opt_state, lr, hr):
        count = float(sum(t.numel() for t in hr.own_rows()))

        def band_losses():
            for d, s, win in _cells(lr):
                o = hr.own[d][s]
                err = model.apply(params[str(win.device)], win)[:, o] \
                    - hr.windows[d][s][:, o]
                yield (err * err).sum() / count

        return params, opt_state, _run(params, opt_state, band_losses)

    return (step, _shard_fn(model, mesh, data_axis, spatial_axis),
            _replicate_fn(mesh))
