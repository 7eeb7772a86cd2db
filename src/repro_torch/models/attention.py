"""GQA attention for the dense decoder: prefill (full causal) and decode.

Port of ``repro.models.attention`` for ``attn`` blocks.  Two implementations
of the score/softmax/value core, chosen by ``impl``:

* ``ref``    — ``_rect_attention`` / the plain decode math: plain PyTorch,
  the model's reference path.
* ``kernel`` — ``kernels.ops``: the hand-written CUDA kernels B1 (prefill)
  and B2 (decode) on the card; their plain versions for CPU tensors.

KV cache: a ring buffer whose entries carry their absolute positions
(``pos = -1`` marks an empty slot), so masking is position-based and the
ring wrap needs no special case.  Unlike the reference, which is pure, the
cache is updated in place: a full-width cache is hundreds of MB, and
rewriting it every decode step would cost more than the step.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L

IMPLS = ("ref", "kernel")


def attn_params(gen, cfg, dtype, device):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, (D, H, hd), dtype, device, fan_in=D),
        "wk": L.dense_init(gen, (D, K, hd), dtype, device, fan_in=D),
        "wv": L.dense_init(gen, (D, K, hd), dtype, device, fan_in=D),
        "wo": L.dense_init(gen, (H, hd, D), dtype, device, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((K, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((K, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _project(x, w):
    """x: [B, S, D]; w: [D, n, hd] -> [B, S, n, hd] (one matrix product)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _project_q(params, x, cfg, positions):
    q = _project(x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    if cfg.qk_norm:
        q = L.rms_head_norm(params["q_norm"], q)
    if cfg.use_rope:
        q = L.rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(params, x, cfg, positions):
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        k, v = k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        k = L.rms_head_norm(params["k_norm"], k)
    if cfg.use_rope:
        k = L.rope(k, positions, cfg.rope_theta)
    return k, v


def _out_proj(params, ctx):
    # ctx: [B, S, H, hd]
    wo = params["wo"]
    return ctx.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


# --------------------------------------------------------------------------
# full-sequence attention (prefill)
# --------------------------------------------------------------------------
def _rect_attention(q, k, v, q_pos, kv_pos, *, causal, window, softcap,
                    q_block=256):
    """Chunked rectangular attention. q:[B,S,H,hd] k,v:[B,T,K,hd].

    Query blocks run one after another with the full kv resident, so the
    f32 scores held at once are ``[B, K, G, q_block, T]``."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    outs = []
    for s0 in range(0, S, q_block):
        qi = q[:, s0:s0 + q_block].float()
        qb = qi.shape[1]
        pq = q_pos[s0:s0 + q_block]
        s = torch.einsum("bqkgh,btkh->bkgqt",
                         qi.reshape(B, qb, K, G, hd) * scale, kf)
        s = L.softcap(s, softcap)
        m = torch.ones((qb, T), dtype=torch.bool, device=q.device)
        if causal:
            m &= pq[:, None] >= kv_pos[None, :]
        if window:
            m &= (pq[:, None] - kv_pos[None, :]) < window
        s = torch.where(m, s, torch.full_like(s, kref.NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkh->bqkgh", p, vf)
        outs.append(o.reshape(B, qb, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def full_attention(params, x, positions, *, cfg, impl="kernel"):
    """Causal self-attention over a full sequence; positions: [B, S].

    Returns ``(y, (k, v))``; k and v fill the decode cache after prefill."""
    q = _project_q(params, x, cfg, positions)
    k, v = _project_kv(params, x, cfg, positions)
    sc = cfg.attn_softcap
    if impl == "kernel":
        ctx = kops.flash_attention(q, k, v, causal=True, window=0, softcap=sc)
    elif impl == "ref":
        ctx = _rect_attention(q, k, v, positions[0], positions[0],
                              causal=True, window=0, softcap=sc)
    else:
        raise ValueError(f"attention impl {impl!r}; want one of {IMPLS}")
    return _out_proj(params, ctx), (k, v)


# --------------------------------------------------------------------------
# KV cache (decode)
# --------------------------------------------------------------------------
def init_cache(cfg, batch, max_len, dtype, device):
    K, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, K, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def _ring_write(cache, k_new, v_new, positions):
    """Write one token per batch row at slot = pos % C, in place."""
    C = cache["k"].shape[1]
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    slots = (positions % C).long()
    cache["k"][rows, slots] = k_new
    cache["v"][rows, slots] = v_new
    cache["pos"][rows, slots] = positions.to(torch.int32)
    return cache


def fill_cache(cache, k, v, positions):
    """Prefill: write the (last C) tokens of k/v into the empty cache, in
    place, and return it."""
    C = cache["k"].shape[1]
    S = k.shape[1]
    if S >= C:
        # keep the trailing C tokens; ring slot = pos % C keeps mask logic
        ktail, vtail = k[:, S - C:], v[:, S - C:]
        ptail = positions[:, S - C:]
        # rotate so that entry i sits at slot pos_i % C
        inv = torch.argsort(ptail % C, dim=1)
        rows = torch.arange(k.shape[0], device=k.device)[:, None]
        cache["k"].copy_(ktail[rows, inv])
        cache["v"].copy_(vtail[rows, inv])
        cache["pos"].copy_(ptail[rows, inv])
        return cache
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    cache["pos"][:, :S] = positions
    return cache


def decode_attention(params, x, cache, positions, *, cfg, impl="kernel"):
    """One-token decode. x: [B, 1, D]; positions: [B] absolute positions.

    Writes the token's k/v into ``cache`` in place; returns ``(y, cache)``."""
    B = x.shape[0]
    q = _project_q(params, x, cfg, positions[:, None])
    k_new, v_new = _project_kv(params, x, cfg, positions[:, None])
    cache = _ring_write(cache, k_new[:, 0], v_new[:, 0], positions)
    k, v, cpos = cache["k"], cache["v"], cache["pos"]
    cur = positions.to(torch.int32)
    if impl == "kernel":
        ctx = kops.decode_attention(q[:, 0], k, v, cpos, cur, window=0,
                                    softcap=cfg.attn_softcap)
    elif impl == "ref":
        ctx = kref.decode_attention_ref(q[:, 0], k, v, cpos, cur, window=0,
                                        softcap=cfg.attn_softcap)
    else:
        raise ValueError(f"attention impl {impl!r}; want one of {IMPLS}")
    ctx = ctx.reshape(B, 1, cfg.n_heads, cfg.head_dim).to(x.dtype)
    return _out_proj(params, ctx), cache
