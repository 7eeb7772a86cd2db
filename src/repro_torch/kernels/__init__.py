"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

B1 ``flash_attention`` (prefill) and B2 ``decode_attention`` (flash-decode)
are ported; the reference's ``rglru_scan`` and ``wkv6`` are not ported
yet.  Sources are in ``repro_torch/csrc``, built at first use by
``_build``.
"""
