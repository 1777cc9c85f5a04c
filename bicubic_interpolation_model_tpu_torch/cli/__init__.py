"""Command-line interface: ``python -m bicubic_interpolation_model_tpu_torch.cli``."""
