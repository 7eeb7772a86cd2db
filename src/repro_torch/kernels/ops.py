"""Dispatchers for the attention kernels, in the model's layouts.

Ports of ``repro.kernels.ops.flash_attention`` and ``decode_attention``.
Each pre-scales q by ``hd**-0.5`` in q's own dtype, as the reference does (in
bf16 that changes the rounding), and hands the kernel wrapper tensors in the
model's layouts.  The wrapper takes the plain version for CPU tensors and
launches the CUDA kernel for CUDA tensors.

The analytic FLOP formulas are copied verbatim from the reference.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa


def _prescale(q):
    return (q.float() * q.shape[-1] ** -0.5).to(q.dtype).contiguous()


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: [B, S, H, hd]; k, v: [B, T, K, hd] (GQA) -> [B, S, H, hd]."""
    return _fa.flash_attention(_prescale(q), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, softcap=softcap)


def decode_attention(q, k, v, cpos, cur, *, window=0, softcap=0.0):
    """q: [B, H, hd]; k, v: [B, C, K, hd]; cpos: [B, C]; cur: [B]."""
    return _dec.decode_attention(_prescale(q), k.contiguous(), v.contiguous(),
                                 cpos.contiguous(), cur.contiguous(),
                                 window=window, softcap=softcap)


# analytic FLOP formulas for the roofline ledger (kernels are custom calls,
# so HLO dot parsing cannot see them)
def flash_attention_flops(B, S, T, H, hd, causal):
    full = 4.0 * B * S * T * H * hd          # qk^T + pv
    return full / 2 if causal else full


def decode_attention_flops(B, C, H, hd):
    return 4.0 * B * C * H * hd
