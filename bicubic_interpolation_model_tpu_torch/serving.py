"""Serving API: reusable upscalers (counterpart of
``bicubic_interpolation_model_tpu/serving.py``).

- :class:`Upscaler` — the classical resamplers (nearest, bilinear, bicubic,
  Lanczos) at integer and rational scales and adaptive bicubic at integer
  scales, batch-aware (the batch rides the kernels' ``blockIdx.z``), with a
  :meth:`~Upscaler.stream` that keeps one dispatch in flight while the
  previous frame is fetched.
- :class:`ModelUpscaler` — the learned pipelines behind the same interface:
  WeightPredictor checkpoints and the direct-regression models.

Both return host uint8 HWC arrays; ``fetch=False`` keeps the device tensor
for chaining into other on-device work.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np
import torch

from .models.inference import (build_tail_operands, param_tree,
                               super_resolve, super_resolve_batch,
                               super_resolve_direct)
from .models.zoo import is_weight_predictor, load_model
from .ops.adaptive import adaptive_resize, adaptive_resize_batch
from .ops.resize import resize, resize_batch
from .runtime.device import resolve_device
from .utils.profiling import span


def _host_view(a: np.ndarray, words: tuple | None) -> np.ndarray:
    """RGBA32 words fetched as bytes ([H, 4W] uint8, ``words`` = (H, W))
    viewed as HWC; anything else as it is."""
    return a if words is None else a.reshape(words[0], words[1], 4)


def _start_fetch(out: torch.Tensor, side: torch.cuda.Stream | None = None):
    """Start the device→host copy of a serving result; returns a callable
    that completes it and gives the host array (HWC uint8 for RGBA32 words,
    2-D uint32, whose little-endian bytes are the frame).

    On the card the bytes go with ``non_blocking=True`` into pinned memory
    of the result's own: on ``side``, a stream that first waits on an event
    recorded after the work that made ``out``, so the copy overlaps whatever
    the caller dispatches next, or on the current stream. The callable
    waits on that copy's event alone and returns a numpy view of the pinned
    block, which stays valid as long as the array lives and then goes back
    to PyTorch's host cache for a later frame (a consumer that drops its
    frames reuses a few blocks; one that keeps N frames holds N pinned
    blocks). ``out`` is held until the copy is done, so its device memory is
    not reused under the copy. A CPU tensor is viewed as numpy, as it
    always was. The start is the span ``serve.fetch.start``, the
    callable's wait ``serve.fetch.wait``."""
    with span("serve.fetch.start"):
        words = tuple(out.shape) if (out.dtype == torch.uint32
                                     and out.dim() == 2) else None
        if words is not None:
            out = out.contiguous().view(torch.uint8)
        if out.device.type != "cuda":
            def finish():
                with span("serve.fetch.wait"):
                    return _host_view(out.cpu().numpy(), words)
            return finish
        pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        stream = torch.cuda.current_stream(out.device)
        if side is not None:
            made = torch.cuda.Event()
            made.record(stream)
            side.wait_event(made)
            stream = side
        with torch.cuda.stream(stream):
            pinned.copy_(out, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)

    def finish():
        nonlocal out
        with span("serve.fetch.wait"):
            copied.synchronize()
            out = None                   # copied: its device memory may go
            return _host_view(pinned.numpy(), words)
    return finish


def _fetch(out):
    """Materialize a serving result on the host as HWC uint8 (RGBA32 words,
    2-D uint32, byte-viewed as HWC): :func:`_start_fetch` on the current
    stream, waited for at once."""
    return _start_fetch(out)()


def _stream_grouped(frames, single, batched, group_size):
    """Group consecutive SAME-SHAPE frames up to ``group_size(img)`` per
    launch and preserve output order. Each group's device→host copy starts
    on a side stream as soon as its kernels are dispatched, and the next
    group is dispatched before the generator waits on that copy: on the
    card frame i-1's copy overlaps frame i's kernels. A group's dispatch is
    the span ``stream.dispatch``, closed before any frame is yielded."""
    side = None
    pending = None

    def emit(finish, n):
        host = finish()
        if n == 1:
            yield host
            return
        for i in range(n):                 # [B, H', W', C]
            yield host[i]

    def step(group):
        """Dispatch ``group`` and start its fetch, then hand out the
        pending group's frames; ``group`` is pending next."""
        nonlocal side, pending
        with span("stream.dispatch"):
            out = single(group[0]) if len(group) == 1 else batched(
                np.stack(group))
            if side is None and out.device.type == "cuda":
                side = torch.cuda.Stream(out.device)
            started = _start_fetch(out, side), len(group)
        if pending is not None:
            yield from emit(*pending)
        pending = started

    group: list[np.ndarray] = []
    for frame in frames:
        img = np.asarray(frame)
        limit = group_size(img)
        if group and (img.shape != group[0].shape or len(group) >= limit):
            yield from step(group)
            group = []
        group.append(img)
        if len(group) >= limit:
            yield from step(group)
            group = []
    if group:
        yield from step(group)
    if pending is not None:
        yield from emit(*pending)


def group_size(microbatch, px: int, threshold: int | None,
               target_px: int) -> int:
    """Frames per launch that ``stream(microbatch=...)`` groups for frames
    of ``px`` LR pixels: 1 for None, the int itself (at least 1) for an
    int, and for "auto" ``round(target_px / px)`` (at least 1) below
    ``threshold``, else 1. ``threshold=None`` gives the size "auto" would
    group at whatever the threshold (the latency curve measures that)."""
    if microbatch is None:
        return 1
    if isinstance(microbatch, int):
        return max(1, microbatch)
    if threshold is not None and px >= threshold:
        return 1
    return max(1, int(round(target_px / px)))


@dataclasses.dataclass
class Upscaler:
    """Classical-kernel upscaler. ``device`` defaults to the card; without
    one it raises unless given ``device="cpu"``.

    Every entry point hands its frames to ``ops/resize``, which owns the
    routing: on a CUDA device kernel C (``ops/mxu``) for whatever that
    kernel takes, the plain graph only for what no kernel takes. ``impl``
    takes the JAX package's names (``auto``, ``gather``, ``matmul``,
    ``phase``, ``pallas_mxu``, ``pallas_phase``, ``pallas``); the
    ``pallas*`` names force a kernel's route (its plain version on the
    CPU).

    ``method="adaptive"`` (integer scales only) hands its frames to
    ``ops/adaptive``, which routes them alike: kernel E
    (``ops/adaptive_fused``) on a CUDA device for uint8 frames of 1 to 4
    channels (gray, gray and alpha, RGB, RGBA). There ``impl`` is ``auto``
    (``pallas_phase`` means the same), ``pallas`` or ``jnp``, and
    ``stream`` never groups frames.

    ``bucket``: in the JAX package, frame extents round up to multiples of
    this many LR pixels so one compiled program serves a bucket of sizes,
    bit-exactly. A CUDA kernel takes its extents at run time, so there is
    no program cache to protect: the argument is accepted and changes
    nothing, which keeps the reference's contract (bucketed bytes equal
    unbucketed bytes) by construction. Per-size plan arrays are cached
    device-resident on this instance, so a steady stream uploads only its
    frames."""

    scale: float = 4
    method: str = "bicubic"
    impl: str = "auto"
    a: float = -0.5
    bucket: int | None = None
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        self._weight_cache: dict = {}

    def _kw(self):
        impl = self.impl
        if self.method == "adaptive" and impl == "pallas_phase":
            impl = "auto"
        return dict(impl=impl, a=self.a, device=self._device,
                    weight_cache=self._weight_cache)

    def __call__(self, img_u8, fetch: bool = True):
        """One [H, W(, C)] frame (numpy or tensor). ``fetch=True`` returns
        a host HWC uint8 array; ``fetch=False`` the device tensor: for an
        adaptive RGBA frame that kernel E serves on the card that is the
        RGBA32 word array, uint32 [H*S, W*S], whose little-endian bytes are
        the HWC frame (pass it to :func:`_fetch` or view the bytes
        yourself); otherwise uint8 [H*S, W*S(, C)]."""
        if self.method == "adaptive":
            out = adaptive_resize(img_u8, self.scale, layout="auto",
                                  **self._kw())
        else:
            out = resize(img_u8, self.scale, self.method, **self._kw())
        return _fetch(out) if fetch else out

    def batch(self, imgs_u8, fetch: bool = True):
        """[B, H, W(, C)] same-size images in one kernel launch."""
        if self.method == "adaptive":
            out = adaptive_resize_batch(imgs_u8, self.scale, **self._kw())
        else:
            out = resize_batch(imgs_u8, self.scale, self.method,
                               **self._kw())
        return _fetch(out) if fetch else out

    #: "auto" groups frames below this many LR pixels, set on an NVIDIA
    #: H100 80GB HBM3 at 700 W from the classical tables of the
    #: committed curves results_torch/latency_curve_call{1,2,3}.json
    #: (kernel C, NxN RGBA -> 4x; scripts/torch_latency_curve.py) by the
    #: rule that tests/test_torch_serving_policy.py holds it to: the pixel
    #: count of the smallest measured size at which grouping did not win
    #: in every call (a grouped frame at most 1.05 x a frame launched
    #: alone, on the device and as a served stream frame with its fetch),
    #: or one more than the largest size if it won at every size.
    #: Grouping changes launches, never bytes.
    MICROBATCH_THRESHOLD_PX = 768 * 768
    #: LR pixels per launch that "auto" sizes its groups to
    MICROBATCH_TARGET_PX = 2 ** 20

    def stream(self, frames: Iterable[np.ndarray],
               microbatch: int | str | None = "auto"
               ) -> Iterator[np.ndarray]:
        """Per-frame host results in order: dispatch frame i, then fetch
        frame i-1. ``microbatch``: consecutive SAME-SHAPE frames under
        ``MICROBATCH_THRESHOLD_PX`` are grouped into one kernel launch;
        "auto" sizes groups to ~1 MPix, an int forces that group size,
        None disables grouping (:func:`group_size`); adaptive never
        groups. On a CUDA device grouped values are bit-identical to
        per-frame dispatch (the batch is a grid dimension); the plain
        versions hold the ±1 u8 LSB contract."""
        mb = None if self.method == "adaptive" else microbatch
        yield from _stream_grouped(
            frames, lambda img: self(img, fetch=False),
            lambda g: self.batch(g, fetch=False),
            lambda img: group_size(mb, img.shape[0] * img.shape[1],
                                   self.MICROBATCH_THRESHOLD_PX,
                                   self.MICROBATCH_TARGET_PX))


@dataclasses.dataclass
class ModelUpscaler:
    """Learned SR behind the serving interface, on a checkpoint directory
    that ``models.zoo.load_model`` loads: a native or
    TFJS WeightPredictor, or a direct-regression model of
    ``models.zoo.MODEL_ZOO`` (ESPCN, ESRGAN, SRResNetTPU), which takes
    the frame's RGB channels and returns RGB. ``device`` defaults to the
    card; without one it raises unless given ``device="cpu"``."""

    model_dir: str
    scale: int = 4
    convention: str = "train"
    #: strict mode — the canonical fused f32 program instead of the
    #: phase-packed path
    exact: bool = False
    #: promise that every frame's alpha channel is a constant 255: the
    #: fused tail then computes alpha as round(255*sum(w)) instead of the
    #: 16-tap sum (±1 u8 LSB on alpha only). Explicit opt-in so per-frame,
    #: batch and stream entry points agree.
    opaque_alpha: bool = False
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        self.model, self.params = load_model(self.model_dir,
                                             device=self._device)
        # direct pixel-regression checkpoints take super_resolve_direct;
        # weight predictors the phase-packed super_resolve
        self._direct = not is_weight_predictor(self.model, self.params)
        self._tail_operands = None
        if not self._direct:
            # the fused tail's operands, built once per checkpoint
            with torch.no_grad():
                self._tail_operands = build_tail_operands(
                    param_tree(self.params), self.scale, self.convention)

    def _kw(self):
        return dict(scale=self.scale, convention=self.convention,
                    exact=self.exact, opaque_alpha=self.opaque_alpha,
                    tail_operands=self._tail_operands)

    def __call__(self, lr_u8, fetch: bool = True):
        """One [H, W, C] uint8 frame (numpy or tensor).

        ``fetch=True`` returns a host HWC uint8 array. ``fetch=False``
        returns the device tensor: for a WeightPredictor's RGBA frames on
        the card that is the RGBA32 word array, uint32 [H*S, W*S], whose
        little-endian bytes are the HWC frame (pass it to :func:`_fetch` or
        view the bytes yourself); otherwise uint8 [H*S, W*S, C], with C = 3
        for a direct model.
        """
        with span("serve.upload"):
            lr = torch.as_tensor(lr_u8).to(self._device)
        if self._direct:
            out = super_resolve_direct(self.model, self.params, lr[..., :3])
            return _fetch(out) if fetch else out
        # RGBA frames on the card go out as RGBA32 words through the
        # interleave kernel; the channel count comes from the shape
        use32 = self._device.type == "cuda" and lr.shape[-1] == 4
        out = super_resolve(self.model, self.params, lr,
                            layout="hwc32" if use32 else "hwc", **self._kw())
        return _fetch(out) if fetch else out

    def batch(self, lrs_u8, fetch: bool = True):
        """[B, H, W, C] same-size frames in one launch (the fused tail
        kernel's leading grid dimension, or the convs' batch); uint8
        [B, H*S, W*S, C], C = 3 for a direct model."""
        with span("serve.upload"):
            lrs = torch.as_tensor(lrs_u8).to(self._device)
        if self._direct:
            lrs = lrs[..., :3]
        out = super_resolve_batch(self.model, self.params, lrs, **self._kw())
        return _fetch(out) if fetch else out

    #: "auto" groups frames below this many LR pixels, set on an NVIDIA
    #: H100 80GB HBM3 at 700 W from the learned tables of the committed
    #: curves results_torch/latency_curve_call{1,2,3}.json
    #: (model/wp-1e-3-120, NxN RGBA -> 4x: kernel A, and B on single
    #: frames) by the rule of :attr:`Upscaler.MICROBATCH_THRESHOLD_PX`.
    MICROBATCH_THRESHOLD_PX = 512 * 512
    #: LR pixels per launch that "auto" sizes its groups to
    MICROBATCH_TARGET_PX = 2 ** 18

    def stream(self, frames: Iterable[np.ndarray],
               microbatch="auto") -> Iterator[np.ndarray]:
        """Per-frame host results with dispatch/fetch overlap.
        ``microbatch`` groups consecutive same-shape frames under
        ``MICROBATCH_THRESHOLD_PX`` into one launch (~0.25 MPix per
        dispatch); an int forces that group size, None disables grouping
        (:func:`group_size`). For a direct model a grouped frame may differ
        from a single one by ±1 u8 (cuDNN may pick another algorithm at
        another batch size)."""
        yield from _stream_grouped(
            frames, lambda img: self(img, fetch=False),
            lambda g: self.batch(g, fetch=False),
            lambda img: group_size(microbatch, img.shape[0] * img.shape[1],
                                   self.MICROBATCH_THRESHOLD_PX,
                                   self.MICROBATCH_TARGET_PX))
