"""Entry point of the port (counterpart of ``__graft_entry__.entry``)."""

from __future__ import annotations


def entry(device="cuda"):
    """``(forward, (params, example_lr))``: the learned weight-predictor SR
    forward exactly as ``ModelUpscaler.__call__`` serves it (phase-packed,
    fused CUDA tail on the card), on freshly initialised weights and a
    32x32x4 uint8 frame."""
    import torch

    from .models.inference import super_resolve
    from .models.weight_predictor import init_params

    scale = 4
    model, params = init_params(torch.Generator().manual_seed(0),
                                scale=scale, device=device)

    def forward(params, lr_u8):
        """LR uint8 [H, W, 4] → SR uint8 [H*4, W*4, 4]."""
        return super_resolve(model, params, lr_u8, scale=scale,
                             convention="train")

    example_lr = torch.full((32, 32, 4), 128, dtype=torch.uint8,
                            device=params["params"]["conv_in"]["kernel"].device)
    return forward, (params, example_lr)
