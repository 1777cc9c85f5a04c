"""Entry point of the port (counterpart of ``__graft_entry__.entry``)."""

from __future__ import annotations


def entry(device="cuda"):
    """``(forward, (params, example_lr))``: the learned weight-predictor SR
    forward exactly as ``ModelUpscaler.__call__`` serves it (phase-packed,
    fused CUDA tail on the card), on freshly initialised weights and a
    32x32x4 uint8 frame."""
    import torch

    from .models.inference import super_resolve
    from .models.weight_predictor import init_params

    scale = 4
    model, params = init_params(torch.Generator().manual_seed(0),
                                scale=scale, device=device)

    def forward(params, lr_u8):
        """LR uint8 [H, W, 4] → SR uint8 [H*4, W*4, 4]."""
        return super_resolve(model, params, lr_u8, scale=scale,
                             convention="train")

    example_lr = torch.full((32, 32, 4), 128, dtype=torch.uint8,
                            device=params["params"]["conv_in"]["kernel"].device)
    return forward, (params, example_lr)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Counterpart of ``__graft_entry__.dryrun_multichip``: on an
    ``n_devices`` (data x spatial) mesh, one sharded WeightPredictor train
    step and one sharded ``SRResNetTPU(features=32, n_blocks=1)`` step on
    tiny shapes, then the sharded inference paths (classical bands, kernel
    C per band, the batch over kernel D, adaptive bands over kernel E,
    learned bands with the graph tail and with kernel G) and the
    single-frame learned tail (kernel A against the graph), each checked.

    The mesh takes the first ``n_devices`` visible devices of ``device``'s
    type; where fewer are visible it repeats ``device`` (as the JAX
    function falls back to virtual CPU devices), and its printed line says
    so. ``device="cpu"`` runs the kernels' plain versions."""
    import numpy as np
    import torch

    from .models.inference import _super_resolve_packed
    from .models.srresnet_tpu import SRResNetTPU
    from .models.weight_predictor import WeightPredictor
    from .ops.learned import gt_weight_map, offset_map
    from .parallel.batch import resize_batch_sharded
    from .parallel.mesh import _grid
    from .parallel.spatial import (adaptive_resize_spatial_sharded,
                                   learned_resize_spatial_sharded,
                                   resize_spatial_sharded)
    from .parallel.train_sharding import (make_sharded_direct_step,
                                          make_sharded_train_step)
    from .runtime.device import resolve_device
    from .train.trainer import adam, fresh_params

    dev = resolve_device(device)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    repeated = len(visible) < n_devices
    devs = [dev] * n_devices if repeated else visible[:n_devices]
    mesh = _grid(devs, ("data", "spatial"), None)
    dp, sp = mesh.shape["data"], mesh.shape["spatial"]
    scale = 4
    h = w = 8 * sp  # tiny LR patch, divisible by the spatial axis
    b = dp

    model = WeightPredictor(scale=scale)
    params = fresh_params(model, dev, 0)
    n = h * scale
    img = np.zeros((b, h, w, 4), np.float32)
    off = np.broadcast_to(offset_map(n, n, float(scale), device="cpu")
                          .numpy()[None], (b, n, n, 2))
    y = np.broadcast_to(gt_weight_map(n, n, float(scale), device="cpu")
                        .numpy()[None], (b, n, n, 16))
    mask = np.ones((b, n, n, 1), np.float32)
    optimizer = adam(1e-4)
    step, shard_batch, replicate = make_sharded_train_step(model, mesh)
    rparams = replicate(params)
    opt_state = optimizer.init(rparams)
    rparams, opt_state, loss = step(rparams, opt_state,
                                    *shard_batch(img, off, y, mask))
    if not np.isfinite(float(loss)):
        raise RuntimeError("non-finite loss in the sharded train step")

    # the band-sharded classical resize (matmuls per band, then kernel C)
    lr = (torch.arange(h * w * 4, dtype=torch.float32).reshape(h, w, 4)
          / 7.0).to(dev)
    out = resize_spatial_sharded(lr, scale, mesh=mesh)
    if tuple(out.shape) != (h * scale, w * scale, 4):
        raise RuntimeError(f"sharded resize gave {tuple(out.shape)}")
    lr_u8 = (lr % 255.0).to(torch.uint8)
    if sp > 1:
        mout = resize_spatial_sharded(lr_u8, scale, mesh=mesh, impl="mxu")
        if tuple(mout.shape) != (h * scale, w * scale, 4):
            raise RuntimeError(f"kernel C bands gave {tuple(mout.shape)}")

    # the data-parallel batch over kernel D per shard
    bout = resize_batch_sharded(
        torch.zeros((2 * dp * sp, 8, 8, 4), dtype=torch.uint8, device=dev),
        scale, mesh=_grid(devs, ("data", "spatial"), 1))
    if tuple(bout.shape) != (2 * dp * sp, 8 * scale, 8 * scale, 4):
        raise RuntimeError(f"sharded batch gave {tuple(bout.shape)}")

    if sp > 1:
        aout = adaptive_resize_spatial_sharded(lr_u8, scale, mesh=mesh)
        if tuple(aout.shape) != (h * scale, w * scale, 4):
            raise RuntimeError(f"adaptive bands gave {tuple(aout.shape)}")
        trained = next(iter(rparams.values()))
        lout = learned_resize_spatial_sharded(model, trained, lr_u8, scale,
                                              mesh=mesh, tail="graph")
        kout = learned_resize_spatial_sharded(model, trained, lr_u8, scale,
                                              mesh=mesh, tail="kernel")
        d = int((kout.int() - lout.int()).abs().max())
        if d > 1:
            raise RuntimeError(f"kernel G bands deviate {d} LSB")

    # the single-frame fused tail (kernel A) against the graph tail
    fused = _super_resolve_packed(params, lr_u8, scale, "train",
                                  tail="kernel")
    graph = _super_resolve_packed(params, lr_u8, scale, "train",
                                  tail="graph")
    d = int((fused.int() - graph.int()).abs().max())
    if d > 1:
        raise RuntimeError(f"fused tail deviates {d} LSB")
    if float(fused.float().std()) == 0:
        raise RuntimeError("fused tail emitted a constant frame")

    # dp x sp sharded training of the direct-SR flagship
    net = SRResNetTPU(scale=scale, features=32, n_blocks=1)
    nparams = fresh_params(net, dev, 1)
    dstep, dshard, drepl = make_sharded_direct_step(net, mesh)
    nparams = drepl(nparams)
    nopt = optimizer.init(nparams)
    lr_b = np.zeros((b, h, w, 3), np.float32)
    hr_b = np.zeros((b, h * scale, w * scale, 3), np.float32)
    nparams, nopt, dloss = dstep(nparams, nopt, *dshard(lr_b, hr_b))
    if not np.isfinite(float(dloss)):
        raise RuntimeError("non-finite loss in the direct-SR step")

    where = (f"{n_devices} x {dev} (repeated: {len(visible)} visible)"
             if repeated else f"{n_devices} {dev.type} devices")
    print(f"dryrun_multichip ok: mesh {mesh.shape} on {where}, "
          f"loss={float(loss):.6f}")
