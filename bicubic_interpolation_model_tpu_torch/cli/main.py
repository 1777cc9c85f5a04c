"""Command-line interface — replaces the reference's npm scripts
(version3.0/package.json:6-24) and the sr.sh batch script with one typed CLI:

  npm run bsr/nsr/bisr/lsr/absr →  sr --method bicubic|nearest|bilinear|lanczos|adaptive
  npm run msr                   →  sr --method model --model-dir <ckpt>
  sr.sh                         →  sr-all
  npm run data / td             →  data --split train|test
  npm run train                 →  train
  npm run vd                    →  validate-data
  npm run vm                    →  validate-model
  npm run cpm                   →  compare-model
  npm run cpi                   →  eval
  (new)                         →  bench, make-lr, train-sr

Workspace layout mirrors the reference's version3.0 tree (cp_image/,
cp_performance/, data/, model/) so artifacts are directly comparable.

The PyTorch/CUDA port's CLI: the same subcommands, options and workspace
files as ``bicubic_interpolation_model_tpu.cli``. Every command runs on
the card; ``--cpu`` runs it on the CPU (the kernels' plain versions), and
without a card a command that computes raises unless given ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

METHODS_CLASSICAL = ("nearest", "bilinear", "bicubic", "lanczos", "adaptive")
DIRECT_MODELS = ("espcn_medium", "espcn_thick", "esrgan_lite", "esrgan_plus",
                 "srresnet_tpu")


def _ws(args) -> pathlib.Path:
    return pathlib.Path(args.workspace)


def _device(args):
    from ..runtime.device import resolve_device
    return resolve_device("cpu" if args.cpu else "cuda")


def _host(out) -> np.ndarray:
    """A result as a host HWC uint8 array (RGBA32 words viewed as bytes)."""
    import torch
    if isinstance(out, torch.Tensor):
        from ..serving import _fetch
        return _fetch(out)
    return np.asarray(out)


def cmd_make_lr(args):
    """Downsample an HR image to LR (the first half of ``npm run msr``,
    model_super_resolution.js:20-32, default lanczos3 like the reference)."""
    from ..ops.downsample import downsample
    from ..utils import imageio
    ws = _ws(args)
    hr = imageio.load_rgba(ws / "cp_image" / "hr_images" / f"{args.image_id}.png")
    lr = _host(downsample(hr, float(args.scale), args.down_method,
                          device=_device(args)))
    out = ws / "cp_image" / "lr_images" / f"{args.image_id}_downsample.png"
    imageio.save_png(out, lr)
    print(f"LR written: {out} ({lr.shape[1]}x{lr.shape[0]})")


def _sr_output_name(method: str, a: float, model_dir: str | None = None) -> str:
    if method in ("bicubic", "adaptive"):
        return f"adaptive_bicubic_{a}" if method == "adaptive" else f"bicubic_{a}"
    if method == "model" and model_dir:
        # name outputs by checkpoint like the reference (e.g. 1e-3-30.png)
        return pathlib.Path(model_dir).name
    return method


def cmd_sr(args):
    from ..bench.harness import performance_test
    from ..utils import imageio
    ws = _ws(args)
    dev = _device(args)
    lr_path = (pathlib.Path(args.input) if args.input else
               ws / "cp_image" / "lr_images" / f"{args.image_id}_downsample.png")
    lr = imageio.load_rgba(lr_path)
    scale = args.scale
    method = args.method
    if method not in ("nearest", "bilinear", "bicubic", "lanczos") \
            and float(scale) != int(scale):
        raise SystemExit(
            f"method {method!r} requires an integer --scale, got {scale}")

    if method in ("nearest", "bilinear", "bicubic", "lanczos"):
        from ..ops.resize import resize
        cache: dict = {}
        fn = lambda: resize(lr, scale, method, impl=args.impl, a=args.a,
                            device=dev, weight_cache=cache)
    elif method == "adaptive":
        # serving path: kernel E on the card (RGBA frames leave it as
        # RGBA32 words), the plain graph on the CPU
        from ..serving import Upscaler
        up = Upscaler(scale=int(scale), method="adaptive", a=args.a,
                      device=dev)
        fn = lambda: up(lr, fetch=False)
    elif method == "model":
        from ..models.inference import super_resolve
        from ..models.zoo import load_model
        model, params = load_model(args.model_dir, device=dev)
        # RGBA frames on the card go out as RGBA32 words (kernel B)
        layout = "hwc32" if dev.type == "cuda" and lr.shape[-1] == 4 \
            else "hwc"
        fn = lambda: super_resolve(model, params, lr, scale=int(scale),
                                   exact=args.exact, layout=layout)
    elif method in DIRECT_MODELS:
        from ..models.inference import super_resolve_direct
        from ..models.zoo import load_model
        model, params = load_model(args.model_dir, device=dev)
        fn = lambda: super_resolve_direct(model, params, lr[..., :3])
    else:
        raise SystemExit(f"unknown method {method}")

    test_item = args.test_item or {
        "bicubic": "bsr", "nearest": "nearest", "bilinear": "bilinear",
        "lanczos": "lanczos", "adaptive": "adaptive_bicubic",
    }.get(method, method)
    res = performance_test(fn, test_item=test_item, runs=args.runs,
                           out_dir=ws / "cp_performance")
    out_img = _host(fn())
    if out_img.shape[-1] == 3:
        out_img = np.concatenate(
            [out_img, np.full(out_img.shape[:2] + (1,), 255, np.uint8)], -1)
    out_path = (pathlib.Path(args.output) if args.output else
                ws / "cp_image" / "rebuild_hr_images" / args.image_id /
                f"{_sr_output_name(method, args.a, args.model_dir)}.png")
    imageio.save_png(out_path, out_img)
    print(f"SR complete: {lr.shape[1]}x{lr.shape[0]} → "
          f"{out_img.shape[1]}x{out_img.shape[0]}; best "
          f"{res.best_ms:.2f} ms → {out_path}")


def cmd_sr_all(args):
    """sr.sh: run every available method for the image id — the classical
    five, the weight-predictor (--model-dir or newest workspace wp-*), and
    any neural baselines with checkpoints under <workspace>/model/."""
    ws = _ws(args)
    runs: list[tuple[str, str | None]] = [(m, None) for m in METHODS_CLASSICAL]
    model_dir = args.model_dir
    if not model_dir:
        wps = sorted((ws / "model").glob("wp-*")) if (ws / "model").exists() else []
        model_dir = str(wps[-1]) if wps else None
    if model_dir:
        runs.append(("model", model_dir))
    for name in DIRECT_MODELS:
        d = ws / "model" / name
        if (d / "params.msgpack").exists():
            runs.append((name, str(d)))
    for m, mdir in runs:
        sub = argparse.Namespace(**vars(args))
        sub.method = m
        sub.model_dir = mdir
        sub.test_item = None
        sub.input = None
        sub.output = None
        sub.exact = getattr(args, "exact", False)
        print(f"=== {m} ===")
        cmd_sr(sub)


def cmd_data(args):
    from ..data.div2k import process_images
    ws = _ws(args)
    recs = process_images(args.hr_dir, ws / "data", scale=args.scale,
                          split=args.split, down_method=args.down_method,
                          adaptive=args.adaptive, limit=args.limit,
                          device=_device(args))
    print(f"generated {len(recs)} samples → {ws / 'data' / args.split}")


def cmd_train(args):
    from ..data.binfmt import load_triplets
    from ..models.weight_predictor import WeightPredictor
    from ..train import checkpoint
    from ..train.trainer import TrainConfig, WeightPredictorTrainer
    ws = _ws(args)
    data = load_triplets(ws / "data" / "train")
    cfg = TrainConfig(learning_rate=args.lr, epochs=args.epochs,
                      mode=args.mode, batch_size=args.batch_size,
                      patch_lr=args.patch_lr, scale=args.scale,
                      image_batch=args.image_batch)
    trainer = WeightPredictorTrainer(WeightPredictor(scale=args.scale), cfg,
                                     device=_device(args))
    init = None
    if args.resume:
        init, _ = checkpoint.load(args.resume)
        print(f"resuming from {args.resume}")
    params = trainer.fit(data, params=init)
    out = ws / "model" / args.name
    checkpoint.save(out, params, meta={
        "model": "WeightPredictor", "scale": args.scale,
        "config": vars(args) | {"func": None}, "history": trainer.history})
    print(f"checkpoint saved → {out}")


def cmd_train_sr(args):
    """Train a direct-SR baseline (ESPCN family) from an HR image dir."""
    from ..data.onthefly import load_hr_dir
    from ..models.zoo import MODEL_ZOO
    from ..models.layers import empty_module
    from ..train import checkpoint
    from ..train.direct_trainer import DirectSRConfig, DirectSRTrainer
    ws = _ws(args)
    dev = _device(args)
    data = load_hr_dir(args.hr_dir, scale=args.scale, keep_hr=True,
                       limit=args.limit)
    cfg = DirectSRConfig(learning_rate=args.lr, epochs=args.epochs,
                         patch_lr=args.patch_lr, batch_size=args.batch_size,
                         scale=args.scale)
    # built on the device: the trainer draws its weights there
    model = empty_module(lambda: MODEL_ZOO[args.model](scale=args.scale), dev)
    trainer = DirectSRTrainer(model, cfg, device=dev)
    params = trainer.fit(data)
    out = ws / "model" / args.model
    checkpoint.save(out, params, meta={"model": args.model,
                                       "scale": args.scale,
                                       "history": trainer.history[-5:]})
    print(f"checkpoint saved → {out}")


def cmd_validate_data(args):
    from ..data.validate import validate_dataset
    ws = _ws(args)
    reports = validate_dataset(ws / "data" / args.split)
    bad = [r for r in reports if not r.ok]
    print(f"{len(reports) - len(bad)}/{len(reports)} samples valid")
    if bad:
        sys.exit(1)


def cmd_validate_model(args):
    from ..evaluation.model_analysis import validate_model
    ws = _ws(args)
    ok = validate_model(args.model_dir, ws / "data" / args.split,
                        sample_id=args.sample_id, hr_dir=args.hr_dir,
                        device=_device(args))
    sys.exit(0 if ok else 1)


def cmd_compare_model(args):
    from ..evaluation.model_analysis import compare_model
    ws = _ws(args)
    compare_model(args.model_dir, ws / "data" / args.split,
                  out_dir=ws / "cp_model" / pathlib.Path(args.model_dir).name,
                  device=_device(args))


def cmd_eval(args):
    from ..evaluation import compare as cmp
    ws = _ws(args)
    ids = args.image_ids or sorted(
        p.stem for p in (ws / "cp_image" / "hr_images").glob("*.png"))
    if not ids:
        raise SystemExit(f"nothing to evaluate: no HR images under "
                         f"{ws / 'cp_image' / 'hr_images'}")
    methods = args.methods
    if not methods:
        first = ws / "cp_image" / "rebuild_hr_images" / ids[0]
        methods = sorted(p.stem for p in first.glob("*.png")) if first.exists() else []
    if not methods:
        raise SystemExit("nothing to evaluate: no rebuilt images found "
                         "(run `sr`/`sr-all` first or pass --methods)")
    results = cmp.run_comparison(ws / "cp_image", ids, methods)
    avgs = cmp.method_averages(results)
    cmp.export_csv(ws / "cp_image" / "metrics_report.csv", results, avgs)
    print("\nMETHOD            PSNR      SSIM      MSE")
    for m, v in avgs.items():
        print(f"{m:<16} {v.psnr:8.2f} {v.ssim:9.4f} {v.mse:9.2f}")


def cmd_bench(args):
    from ..bench.suite import REFERENCE_BICUBIC_GPIX_S, headline
    dev = _device(args)
    if args.impls:
        impls = tuple(args.impls.split(","))
    else:  # device-appropriate defaults: kernels D and F on the card
        impls = (("pallas_phase", "pallas") if dev.type == "cuda"
                 else ("matmul",))
    best, results = headline(impls=impls, runs=args.runs, device=dev)
    for r in results:
        print(r)
    if best:
        print(json.dumps({
            "metric": "bicubic_4x_throughput",
            "value": round(best["gpix_per_s"], 3), "unit": "GPix/s",
            "vs_baseline": round(best["gpix_per_s"] / REFERENCE_BICUBIC_GPIX_S, 1)}))


def build_parser():
    p = argparse.ArgumentParser(
        prog="bim-tpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workspace", default=".", help="workspace root")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions); "
                        "without it every command that computes runs on "
                        "the card and raises when there is none")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("make-lr", help="downsample HR → LR png")
    sp.add_argument("--image-id")
    sp.add_argument("--scale", type=int, default=4)
    sp.add_argument("--down-method", default="lanczos3")
    sp.set_defaults(func=cmd_make_lr)

    sp = sub.add_parser("sr", help="single-method super-resolution")
    sp.add_argument("--image-id")
    sp.add_argument("--input", help="explicit LR input path")
    sp.add_argument("--output", help="explicit output path")
    sp.add_argument("--method", required=True)
    sp.add_argument("--scale", type=float, default=4)
    sp.add_argument("--impl", default="auto")
    sp.add_argument("--a", type=float, default=-0.5)
    sp.add_argument("--model-dir")
    sp.add_argument("--exact", action="store_true",
                    help="learned SR strict mode: the canonical fused f32 "
                         "program instead of the packed fast path")
    sp.add_argument("--runs", type=int, default=2)
    sp.add_argument("--test-item")
    sp.set_defaults(func=cmd_sr)

    sp = sub.add_parser("sr-all", help="run all methods (sr.sh)")
    sp.add_argument("--image-id")
    sp.add_argument("--scale", type=float, default=4)
    sp.add_argument("--impl", default="auto")
    sp.add_argument("--a", type=float, default=-0.5)
    sp.add_argument("--model-dir")
    sp.add_argument("--runs", type=int, default=2)
    sp.set_defaults(func=cmd_sr_all)

    sp = sub.add_parser("data", help="generate training/test data")
    sp.add_argument("--hr-dir", required=True)
    sp.add_argument("--split", default="train", choices=("train", "test"))
    sp.add_argument("--scale", type=int, default=4)
    sp.add_argument("--down-method", default="cubic")
    sp.add_argument("--adaptive", action="store_true")
    sp.add_argument("--limit", type=int)
    sp.set_defaults(func=cmd_data)

    sp = sub.add_parser("train", help="train the weight predictor")
    sp.add_argument("--name", default="wp")
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--mode", default="patch", choices=("patch", "image"))
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--patch-lr", type=int, default=64)
    sp.add_argument("--image-batch", type=int, default=1,
                    help="image mode: same-bucket images per step "
                         "(1 = the reference's per-image updates; >1 "
                         "batch-mean gradients)")
    sp.add_argument("--scale", type=int, default=4)
    sp.add_argument("--resume", help="checkpoint dir to resume from")
    sp.set_defaults(func=cmd_train)

    sp = sub.add_parser("train-sr", help="train a direct SR model "
                                         "(ESPCN/ESRGAN/SRResNetTPU family)")
    sp.add_argument("--model", default="espcn_medium",
                    choices=DIRECT_MODELS)
    sp.add_argument("--hr-dir", required=True)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--epochs", type=int, default=50)
    sp.add_argument("--patch-lr", type=int, default=32)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--scale", type=int, default=4)
    sp.add_argument("--limit", type=int)
    sp.set_defaults(func=cmd_train_sr)

    sp = sub.add_parser("validate-data", help="validate the dataset (vd)")
    sp.add_argument("--split", default="train")
    sp.set_defaults(func=cmd_validate_data)

    sp = sub.add_parser("validate-model", help="validate a model (vm)")
    sp.add_argument("--model-dir", required=True)
    sp.add_argument("--split", default="test")
    sp.add_argument("--sample-id")
    sp.add_argument("--hr-dir", help="HR images for the rebuild PSNR check")
    sp.set_defaults(func=cmd_validate_model)

    sp = sub.add_parser("compare-model", help="GT-vs-predicted weights (cpm)")
    sp.add_argument("--model-dir", required=True)
    sp.add_argument("--split", default="test")
    sp.set_defaults(func=cmd_compare_model)

    sp = sub.add_parser("eval", help="quality evaluation sweep (cpi)")
    sp.add_argument("--image-ids", nargs="*")
    sp.add_argument("--methods", nargs="*")
    sp.set_defaults(func=cmd_eval)

    sp = sub.add_parser("bench", help="performance benchmarks")
    sp.add_argument("--impls", help="comma list; default auto per device")
    sp.add_argument("--runs", type=int, default=5)
    sp.set_defaults(func=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # workspace config supplies the image-id default (the reference's
    # config.js HRID knob); an explicit --image-id always wins.
    if hasattr(args, "image_id") and args.image_id is None:
        from ..utils.config import WorkspaceConfig
        args.image_id = WorkspaceConfig.load(args.workspace).hrid
    return args.func(args)


if __name__ == "__main__":
    main()
