"""What a checkpoint directory holds and how it is served, the one module
that names the port's architectures: :data:`MODEL_ZOO`, the
direct-regression models a native checkpoint's ``meta["model"]`` may name
(served by ``inference.super_resolve_direct``); :func:`load_model`, which
opens any checkpoint the serving layer serves; :func:`is_weight_predictor`,
the route (a weight predictor takes ``inference.super_resolve``'s learned
path). A new architecture is added in its own module and here.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
from typing import Callable

from ..runtime.device import resolve_device
from ..train import checkpoint
from .esrgan import ESRGANLite, RRDBNet, load_rrdbnet
from .espcn import ESPCN, ESPCNResidual
from .layers import empty_module
from .srresnet_tpu import SRResNetTPU
from .tfjs_import import load_weight_predictor
from .weight_predictor import LAYERS, WeightPredictor


@dataclasses.dataclass(frozen=True)
class Architecture:
    """``arch(scale=4, **kw)`` builds the module at its checkpoints' widths.
    ``load_published(model_dir, meta, *, device) -> (model, params)``, where
    the architecture has published weights, loads a directory whose
    ``meta.json`` names a state dict (``"state_dict"``) or a seeded init
    (``"init"``) in place of ``params.msgpack``."""

    build: Callable
    load_published: Callable | None = None

    def __call__(self, scale: int = 4, **kw):
        return self.build(scale=scale, **kw)


MODEL_ZOO = {
    "espcn_medium": Architecture(ESPCN),
    "espcn_thick": Architecture(ESPCNResidual),
    # the widths of the shipping model/esrgan_lite and model/esrgan_plus
    "esrgan_lite": Architecture(functools.partial(
        ESRGANLite, features=64, growth=32, n_blocks=6)),
    "esrgan_plus": Architecture(functools.partial(
        ESRGANLite, features=96, growth=48, n_blocks=8)),
    # the published RRDB_ESRGAN_x4 / RealESRGAN_x4plus generator
    "esrgan_x4": Architecture(functools.partial(
        RRDBNet, features=64, growth=32, n_blocks=23), load_rrdbnet),
    "srresnet_tpu": Architecture(functools.partial(
        SRResNetTPU, features=128, n_blocks=6)),
}
#: every native checkpoint's ``meta["model"]`` (absent: a WeightPredictor)
_NATIVE = {WeightPredictor.__name__: Architecture(WeightPredictor),
           **MODEL_ZOO}


def is_weight_predictor(model, params) -> bool:
    """A :class:`WeightPredictor` whose tree (``{"params": ...}`` or the
    inner dict) holds its six layers; anything else is served direct."""
    tree = params.get("params", params) if hasattr(params, "get") else params
    return (isinstance(model, WeightPredictor)
            and all(k in tree for k in LAYERS))


def load_model(model_dir, *, device="cuda"):
    """``(model, params)`` of a checkpoint directory on ``device``: a TFJS
    WeightPredictor (``model.json``); an architecture's published weights
    (:class:`Architecture`); or ``params.msgpack`` with a ``meta.json``
    whose ``"model"`` is in :data:`_NATIVE`. The MLP predictors load by
    ``mlp_predictor.load_mlp``; any other name raises ValueError."""
    dev = resolve_device(device)
    d = pathlib.Path(model_dir)
    if (d / "model.json").exists():
        return load_weight_predictor(d, device=dev)
    meta_path = d / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    arch = _NATIVE.get(meta.get("model"))
    if arch is not None and arch.load_published is not None and (
            "state_dict" in meta or "init" in meta):
        return arch.load_published(d, meta, device=dev)
    tree, meta = checkpoint.load(d)
    name = meta.get("model", WeightPredictor.__name__)
    if name not in _NATIVE:
        raise ValueError(
            f"{d}: model {name!r} is neither a MODEL_ZOO entry "
            f"({', '.join(MODEL_ZOO)}) nor a WeightPredictor; MLP "
            "predictors load by models.mlp_predictor.load_mlp")
    scale = int(meta.get("scale", 4))
    model = empty_module(lambda: _NATIVE[name](scale=scale), dev)
    model.load_tree(tree)
    return model, model.tree()
