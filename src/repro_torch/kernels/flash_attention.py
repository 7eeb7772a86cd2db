"""B1, flash attention for prefill: the CUDA kernel's wrapper and its plain
version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bkgs``.  Unlike the
Pallas kernel, it reads the model's layouts directly (q ``[B,S,H,hd]``, k/v
``[B,T,K,hd]``), so there is no ``[B·K, G, S, hd]`` rearrangement around
the call.  q arrives pre-scaled by ``hd**-0.5`` (``ops.flash_attention``).

``flash_attention`` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 64                         # query heads per kv head
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, out; dtype, B, S, T, H, K, hd, causal, window; softcap; device;
# stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

launches = 0                           # kernel launches since the last reset


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The kernel's function in plain PyTorch (q pre-scaled)."""
    return ref.attention_core(q, k, v, causal=causal, window=window,
                              softcap=softcap).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    Bk, T, K, hdk = k.shape
    if Bk != B or hdk != hd or K == 0 or H % K or S == 0 or T == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"flash_attention: hd={hd}, G={H // K} unsupported "
                         f"(hd in {HEAD_DIMS}, G <= {MAX_GROUP})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of {list(DTYPES)}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def flash_attention_cuda(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Launch the kernel.  q: [B,S,H,hd] pre-scaled; k, v: [B,T,K,hd]."""
    global launches
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "repro_flash_attention_fwd",
                         _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], B, S, T, H, K, hd, int(bool(causal)),
            int(window), float(softcap), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(fn, rc, "flash_attention launch")
    launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: [B,S,H,hd] pre-scaled; k, v: [B,T,K,hd] -> [B,S,H,hd]."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap)
