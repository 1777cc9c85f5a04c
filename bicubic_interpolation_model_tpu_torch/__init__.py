"""bicubic_interpolation_model_tpu_torch — the PyTorch/CUDA port of
``bicubic_interpolation_model_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package stays the reference; this package re-implements its paths
in PyTorch, and every Pallas kernel on a ported path becomes a CUDA C++
kernel written by hand (``csrc/``, built by :mod:`.runtime.build` on first
use). It imports nothing of the JAX package.

Ported: learned-SR serving, classical resize serving, adaptive bicubic
serving, band/batch-sharded serving, the direct-regression and MLP
baselines, evaluation and image I/O, data generation and training, the
bench and the CLI:

core        interpolation kernels, axis plans and the float64 JS-semantics
            oracle (NumPy, float64, host)
bench       performance harness (reference CSV schema, fenced on the card)
            and the suite behind ``bench_torch.py`` (headline, parity)
cli         ``python -m bicubic_interpolation_model_tpu_torch.cli``: the
            JAX package's eleven subcommands
train       msgpack checkpoint reader and writer (flax's bytes, no
            flax/msgpack needed); the trainers of the weight predictor
            (patch and image mode), the direct models and the MLPs
models      WeightPredictor, PixelShuffleUpsample, learned SR inference;
            the direct-regression models of ``espcn.MODEL_ZOO`` (ESPCN,
            ESPCNResidual, ESRGANLite, the published ESRGAN RRDBNet,
            SRResNetTPU: cuDNN convs, no TPU kernel on their path) and
            ``super_resolve_direct``; the MLP
            weight predictors (``mlp_predictor``); the TFJS importer
ops         offsets / GT weights / apply-weights, the fused packed tail
            (CUDA kernel A) and the tail on a precomputed merged map (CUDA
            kernel G), the planar→RGBA32 interleave (CUDA kernel B);
            resize (gather / matmul / phase and the dispatch), the
            plan-driven resize at any rational scale (CUDA kernel C,
            ``ops/mxu``), the phase-FMA resize at integer scales (CUDA
            kernel D, ``ops/phase``), the banded-matrix resize behind
            ``impl="pallas"`` (CUDA kernel F, ``ops/banded``); adaptive
            bicubic (``ops/adaptive``: the plain graph and the dispatch;
            CUDA kernel E, ``ops/adaptive_fused``); antialiased downsample
evaluation  checkpoint loading by ``meta.json``, weight-map validation and
            analysis, PSNR/SSIM/MSE, ``metrics_report.csv``
data        the header-prefixed float32 tensor files (``binfmt``), DIV2K
            sample generation (``div2k``), the Y-less loader
            (``onthefly``), dataset validation
utils       image I/O (native codec or PIL), workspace configuration,
            profiling (torch.profiler traces, memory, anomaly mode) and
            ``span``: the serving path's ranges, recorded only under a
            profiler (``serve.upload``, ``model.step``,
            ``resize.dispatch``, ``serve.fetch.start``,
            ``serve.fetch.wait``, ``stream.dispatch``) and
            ``span_split``, a trace's host and idle time by them
serving     ModelUpscaler (WeightPredictor and direct checkpoints), Upscaler
parallel    a named grid of devices (``Mesh``, which may repeat a device),
            band-sharded learned / classical / adaptive SR of one frame
            (kernels G, C, E per band) and batch-sharded resize (kernel D
            per shard) in one process; data x spatial sharded train
            steps; multi-host process-group setup
runtime     device resolution, nvcc build + ctypes binding of ``csrc/*.cu``,
            g++ build + ctypes binding of the root ``csrc/`` image/tensor IO

Entry points take ``device=`` and default to ``"cuda"``; with no card they
raise unless the caller asks for ``device="cpu"``. Functions that take
tensors run where their tensors lie.
"""

__version__ = "0.1.0"
