"""bicubic_interpolation_model_tpu_torch — the PyTorch/CUDA port of
``bicubic_interpolation_model_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package stays the reference; this package re-implements its paths
in PyTorch, and every Pallas kernel on a ported path becomes a CUDA C++
kernel written by hand (``csrc/``, built by :mod:`.runtime.build` on first
use). It imports nothing of the JAX package.

Ported: learned-SR serving, classical resize serving, adaptive bicubic
serving, band/batch-sharded serving, the direct-regression and MLP
baselines, evaluation and image I/O, data generation and training, the
bench and the CLI. Subpackages by layer, bottom up: a module imports its
own subpackage, lower layers, peers where noted, and the leaf
``train/checkpoint.py`` (``tests/test_torch_layers.py``).

1 runtime   device resolution, the f32 contexts (cuDNN, cuBLAS TF32 off),
            nvcc / g++ builds + ctypes bindings of ``csrc/*.cu`` and the
            root ``csrc/`` image/tensor IO
1 utils     image I/O (native codec or PIL; reads ``runtime``), workspace
            configuration, profiling (torch.profiler traces, memory,
            anomaly mode) and ``span``: the serving path's ranges,
            recorded only under a profiler (``serve.upload``,
            ``model.step``, ``resize.dispatch``, ``serve.fetch.start``,
            ``serve.fetch.wait``, ``stream.dispatch``) and
            ``span_split``, a trace's host and idle time by them
2 core      interpolation kernels, axis plans and the float64 JS-semantics
            oracle (NumPy, float64, host)
3 ops       offsets / GT weights / apply-weights, the fused packed tail
            (CUDA kernel A) and the tail on a precomputed merged map (CUDA
            kernel G) with the plain tail math they are held to, the
            planar→RGBA32 interleave (CUDA kernel B); resize (gather /
            matmul / phase and the dispatch), the plan-driven resize at
            any rational scale (CUDA kernel C, ``ops/mxu``), the phase-FMA
            resize at integer scales (CUDA kernel D, ``ops/phase``), the
            banded-matrix resize behind ``impl="pallas"`` (CUDA kernel F,
            ``ops/banded``); adaptive bicubic (``ops/adaptive``: the plain
            graph and the dispatch; CUDA kernel E, ``ops/adaptive_fused``);
            antialiased downsample; 3x3 convs on channel-major frames with
            their bias and epilogue, 3xTF32 on the tensor cores
            (``ops/conv3x3``, the port's own CUDA kernel: no TPU kernel
            has its place)
4 models    ``zoo`` (what a checkpoint is and which route it takes);
            WeightPredictor, learned SR inference; the direct-regression
            models (ESPCN, ESPCNResidual, ESRGANLite, SRResNetTPU: cuDNN
            convs; the published ESRGAN RRDBNet: with grad off its
            float32 card convs on ``ops/conv3x3``, but for the first and
            last on cuDNN; no TPU kernel on their path) and
            ``super_resolve_direct``; the MLP weight predictors
            (``mlp_predictor``); the TFJS importer
4 data      the header-prefixed float32 tensor files (``binfmt``), DIV2K
            sample generation (``div2k``), the Y-less loader
            (``onthefly``), dataset validation
5 serving   ModelUpscaler (WeightPredictor and direct checkpoints), Upscaler
5 parallel  a named grid of devices (``Mesh``, which may repeat a device),
            band-sharded learned / classical / adaptive SR of one frame
            (kernels G, C, E per band) and batch-sharded resize (kernel D
            per shard) in one process; data x spatial sharded train
            steps (on ``train``'s steps); multi-host process-group setup
5 evaluation  weight-map validation and analysis, PSNR/SSIM/MSE,
            ``metrics_report.csv``
5 train     msgpack checkpoints (flax's bytes, no flax/msgpack needed);
            the trainers of the weight predictor, direct models and MLPs
6 bench     performance harness (reference CSV schema, fenced on the card)
            and the suite behind ``bench_torch.py`` (headline, parity)
6 cli       ``python -m bicubic_interpolation_model_tpu_torch.cli``: the
            JAX package's eleven subcommands (on ``bench``)
6 entry     ``entry()`` and the multi-device dry run

Entry points take ``device=`` and default to ``"cuda"``; with no card they
raise unless the caller asks for ``device="cpu"``. Functions that take
tensors run where their tensors lie.
"""

__version__ = "0.1.0"
