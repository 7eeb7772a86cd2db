"""Shared neural layers: norms, RoPE, MLPs, initializers.

Plain functions on tensors; parameters are nested dicts of tensors laid out
as in ``repro.models.layers``.  Every initializer takes an explicit
``torch.Generator`` (on the device the tensor is made on).  Norms compute in
f32 regardless of the activation dtype and cast back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6
_TRUNC_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------
def _truncated_normal(gen, shape, device):
    """Standard normal truncated to [-2, 2], by the inverse CDF (one pass)."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u = _TRUNC_LO + (1.0 - 2.0 * _TRUNC_LO) * u
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return x.clamp_(-2.0, 2.0)


def dense_init(gen, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    std = (1.0 / max(1, fan_in)) ** 0.5
    return (_truncated_normal(gen, shape, device) * std).to(dtype)


def embed_init(gen, shape, dtype, device):
    return (_truncated_normal(gen, shape, device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def norm_params(d, kind, dtype, device):
    if kind == "rms":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layer":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(params, x, kind):
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + NORM_EPS)
        y = y * params["scale"].float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + NORM_EPS)
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(scale, x):
    """RMSNorm over the trailing (head_dim) axis — qk-norm."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + NORM_EPS)
    return (y * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings (half-split / NeoX convention)
# --------------------------------------------------------------------------
def rope(x, positions, theta):
    """x: [..., S, n_heads, head_dim]; positions: [..., S] integer."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq                 # [..., S, half]
    ang = ang[..., None, :]                                    # heads dim
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_params(gen, d, f, kind, dtype, device):
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (d, f), dtype, device),
                "w_up": dense_init(gen, (d, f), dtype, device),
                "w_down": dense_init(gen, (f, d), dtype, device)}
    if kind == "gelu":
        return {"w_in": dense_init(gen, (d, f), dtype, device),
                "b_in": torch.zeros((f,), dtype=dtype, device=device),
                "w_out": dense_init(gen, (f, d), dtype, device),
                "b_out": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_mlp(params, x, kind):
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    if kind == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") \
            * (x @ params["w_up"])
        return h @ params["w_down"]
    if kind == "gelu":
        h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
        return h @ params["w_out"] + params["b_out"]
    raise ValueError(kind)
