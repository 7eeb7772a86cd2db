"""Plain PyTorch versions of the attention kernels (materializing, no blocking).

Ports of ``repro.kernels.ref.attention_ref`` and ``decode_attention_ref``.
The ``*_core`` functions take q already scaled by ``hd**-0.5``, as the
kernels do (the dispatchers in ``ops`` pre-scale q in its own dtype); the
``*_ref`` functions scale in f32 themselves, as the reference oracles do.
All math is f32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_core(qs, k, v, *, causal=True, window=0, softcap=0.0):
    """qs: [B, S, H, hd] pre-scaled; k, v: [B, T, K, hd] -> f32 [B, S, H, hd]."""
    B, S, H, hd = qs.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = qs.float().reshape(B, S, K, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qf, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pq = torch.arange(S, device=qs.device)[:, None]
    pk = torch.arange(T, device=qs.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=qs.device)
    if causal:
        mask &= pq >= pk
    if window:
        mask &= (pq - pk) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H, hd)


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: [B, S, H, hd]; k, v: [B, T, K, hd] (GQA) -> [B, S, H, hd]."""
    hd = q.shape[-1]
    return attention_core(q.float() * hd ** -0.5, k, v, causal=causal,
                          window=window, softcap=softcap).to(q.dtype)


def decode_attention_core(qs, k, v, cpos, cur, *, window=0, softcap=0.0):
    """qs: [B, H, hd] pre-scaled; k, v: [B, C, K, hd]; cpos: [B, C];
    cur: [B] -> f32 [B, H, hd].  A slot counts iff cpos >= 0, cpos <= cur
    and (with a window) cur - cpos < window."""
    B, H, hd = qs.shape
    C, K = k.shape[1], k.shape[2]
    G = H // K
    qf = qs.float().reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bckh->bkgc", qf, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (cpos >= 0) & (cpos <= cur[:, None])
    if window:
        valid &= (cur[:, None] - cpos) < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckh->bkgh", p, v.float())
    return o.reshape(B, H, hd)


def decode_attention_ref(q, k, v, cpos, cur, *, window=0, softcap=0.0):
    """q: [B, H, hd]; k, v: [B, C, K, hd]; cpos: [B, C]; cur: [B]."""
    hd = q.shape[-1]
    return decode_attention_core(q.float() * hd ** -0.5, k, v, cpos, cur,
                                 window=window,
                                 softcap=softcap).to(q.dtype)
