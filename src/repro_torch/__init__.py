"""PyTorch/CUDA port of the ``repro`` model stack, for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports nothing
of it and never imports ``jax``.  Module names mirror ``src/repro/``.  Its
public functions keep the reference's layouts (q ``[B,S,H,hd]``, k/v
``[B,T,K,hd]``, caches ``[B,C,K,hd]``), so the tests compare like with like.

Float32 means full float32 on the card: importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``, because the JAX reference
computes in full f32 and TF32 keeps only about three decimal digits.

Entry points (``models.model.init_params``, ``serve.engine.Engine``,
``launch.serve``) run on the card unless the caller passes ``device="cpu"``.
Without a card they raise; they never move to the CPU on their own.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    return dev
