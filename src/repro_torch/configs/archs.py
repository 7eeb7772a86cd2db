"""The dense ``("attn",)`` architectures the port runs, with the exact dims of
``repro.configs.archs``.

All three are all-attention decoders: ``(attn,) × n_layers``.  The other
architectures of the reference (local/global, RG-LRU, RWKV, MoE, encoder and
media models) are not ported yet.
"""
from repro_torch.configs.base import ArchConfig, register

SMOLLM_360M = register(ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=49_152,
    pattern_unit=("attn",), n_units=32,
    rope_theta=10_000.0, ffn_kind="swiglu", tied_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
))

LLAMA32_1B = register(ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128_256,
    pattern_unit=("attn",), n_units=16,
    rope_theta=500_000.0, ffn_kind="swiglu", tied_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
))

QWEN2_05B = register(ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151_936,
    pattern_unit=("attn",), n_units=24,
    rope_theta=1_000_000.0, qkv_bias=True, ffn_kind="swiglu",
    tied_embeddings=True,
    source="arXiv:2407.10671; hf",
))

ALL = [SMOLLM_360M, LLAMA32_1B, QWEN2_05B]
