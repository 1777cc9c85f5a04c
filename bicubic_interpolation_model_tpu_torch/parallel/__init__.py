"""Band ("spatial") and batch ("data") parallel serving over a grid of
devices (counterpart of ``bicubic_interpolation_model_tpu/parallel``)."""
