"""Import the reference's TFJS layers-format checkpoints (``model.json`` +
``weights.bin``) into the port's :class:`.weight_predictor.WeightPredictor`
(counterpart of ``bicubic_interpolation_model_tpu/models/tfjs_import.py``).

``model.json`` carries ``weightsManifest``: an ordered list of tensors
(name, shape, dtype) concatenated raw in the listed files (float32 LE).
Conv kernels are [kh, kw, in, out] (as flax); the transpose-conv kernel is
[kh, kw, out, in], the port's PixelShuffleUpsample layout.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

# manifest tensor name → WeightPredictor layer
_NAME_MAP = {
    "conv2d_Conv2D1": "conv_in",
    "conv2d_Conv2D2": "conv_res",
    "conv2d_transpose_Conv2DTranspose1": "upsample",
    "conv2d_Conv2D3": "conv_att",
    "conv2d_Conv2D4": "conv_off",
    "conv2d_Conv2D5": "conv_out",
}


def read_tfjs_weights(model_dir) -> dict[str, np.ndarray]:
    """Parse model.json + its weight files into {tensor_name: array}."""
    model_dir = pathlib.Path(model_dir)
    spec = json.loads((model_dir / "model.json").read_text())
    tensors = {}
    for group in spec["weightsManifest"]:
        buf = b"".join((model_dir / p).read_bytes() for p in group["paths"])
        off = 0
        for wspec in group["weights"]:
            if wspec["dtype"] != "float32":
                raise ValueError(f"unsupported dtype {wspec['dtype']}")
            n = int(np.prod(wspec["shape"])) if wspec["shape"] else 1
            arr = np.frombuffer(buf, dtype="<f4", count=n, offset=off)
            tensors[wspec["name"]] = arr.reshape(wspec["shape"]).copy()
            off += n * 4
        if off != len(buf):
            raise ValueError(f"weights.bin size mismatch: {off} != {len(buf)}")
    return tensors


def load_weight_predictor(model_dir, *, device="cuda"):
    """``(model, params)`` with the checkpoint's weights, on ``device``."""
    from ..runtime.device import resolve_device
    from .layers import empty_module
    from .weight_predictor import WeightPredictor

    tensors = read_tfjs_weights(model_dir)
    params = {layer: {"kernel": tensors[f"{name}/kernel"],
                      "bias": tensors[f"{name}/bias"]}
              for name, layer in _NAME_MAP.items()}
    model = empty_module(lambda: WeightPredictor(scale=4),
                         resolve_device(device))
    model.load_tree({"params": params})
    return model, model.tree()


def reference_model_names(reference_root="/root/reference/version3.0"
                          ) -> list[str]:
    """Sorted names of the directories under ``<reference_root>/model``
    that hold a ``model.json``; ``[]`` when there is no such directory."""
    d = pathlib.Path(reference_root) / "model"
    if not d.exists():
        return []
    return sorted(p.name for p in d.iterdir() if (p / "model.json").exists())
