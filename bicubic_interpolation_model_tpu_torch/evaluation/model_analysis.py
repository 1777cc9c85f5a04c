"""Checkpoint loading by ``meta.json`` (counterpart of
``bicubic_interpolation_model_tpu/evaluation/model_analysis._load_model_any``,
WeightPredictor branch)."""

from __future__ import annotations

import pathlib

from ..runtime.device import resolve_device
from ..train import checkpoint


def _load_model_any(model_dir, *, device="cuda"):
    """``(model, params)`` of a shipped checkpoint, on ``device``. Native
    WeightPredictor checkpoints only so far; other ``meta["model"]`` values
    and TFJS directories raise NotImplementedError."""
    from ..models.weight_predictor import WeightPredictor

    dev = resolve_device(device)
    d = pathlib.Path(model_dir)
    if (d / "model.json").exists():
        raise NotImplementedError(
            f"{d}: TFJS checkpoint import is not ported yet")
    tree, meta = checkpoint.load(d)
    name = meta.get("model", "WeightPredictor")
    if name != "WeightPredictor":
        raise NotImplementedError(f"{d}: model {name!r} is not ported yet")
    model = WeightPredictor(scale=int(meta.get("scale", 4))).to(dev)
    model.load_tree(tree)
    return model, model.tree()
