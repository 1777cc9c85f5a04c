"""The benchmark of the PyTorch and CUDA port
(``bicubic_interpolation_model_tpu_torch``): served frames of the learned
4x model and of classical bicubic 4x on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; :mod:`.spec` says
where each cell's parts live.
"""
