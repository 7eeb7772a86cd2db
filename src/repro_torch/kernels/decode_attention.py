"""B2, flash-decode: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention_bk``.  It reads the
model's layouts directly (q ``[B,H,hd]``, the ring cache's k/v
``[B,C,K,hd]`` and positions ``[B,C]``), so the cache is neither transposed
nor its positions repeated per kv head around the call.  q arrives
pre-scaled by ``hd**-0.5`` (``ops.decode_attention``).

``decode_attention`` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP_WIDTH = 1024                 # (H / K) * hd the kernel holds
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, cpos, cur, out; dtype, B, C, H, K, hd, window; softcap; device;
# stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

launches = 0                           # kernel launches since the last reset


def decode_attention_plain(q, k, v, cpos, cur, *, window=0, softcap=0.0):
    """The kernel's function in plain PyTorch (q pre-scaled)."""
    return ref.decode_attention_core(q, k, v, cpos, cur, window=window,
                                     softcap=softcap).to(q.dtype)


def _check(q, k, v, cpos, cur):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, hd = q.shape
    Bk, C, K, hdk = k.shape
    if Bk != B or hdk != hd or K == 0 or H % K or C == 0 \
            or tuple(cpos.shape) != (B, C) or tuple(cur.shape) != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}, cpos {tuple(cpos.shape)}, cur "
                         f"{tuple(cur.shape)} do not fit")
    if hd not in HEAD_DIMS or (H // K) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention: hd={hd}, G={H // K} unsupported "
                         f"(hd in {HEAD_DIMS}, G*hd <= {MAX_GROUP_WIDTH})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of {list(DTYPES)}")
    if cpos.dtype != torch.int32 or cur.dtype != torch.int32:
        raise TypeError("decode_attention: cpos and cur must be int32")
    tensors = (q, k, v, cpos, cur)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all inputs must be on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: all inputs must be contiguous")


def decode_attention_cuda(q, k, v, cpos, cur, *, window=0, softcap=0.0):
    """Launch the kernel.  q: [B,H,hd] pre-scaled; k, v: [B,C,K,hd];
    cpos: [B,C] int32; cur: [B] int32."""
    global launches
    _check(q, k, v, cpos, cur)
    B, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _build.function("decode_attention", "repro_decode_attention_fwd",
                         _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cpos.data_ptr(),
            cur.data_ptr(), out.data_ptr(), DTYPES[q.dtype], B, C, H, K, hd,
            int(window), float(softcap), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(fn, rc, "decode_attention launch")
    launches += 1
    return out


def decode_attention(q, k, v, cpos, cur, *, window=0, softcap=0.0):
    """q: [B,H,hd] pre-scaled; k, v: [B,C,K,hd]; cpos: [B,C]; cur: [B]
    -> [B,H,hd]."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cpos, cur, window=window,
                                      softcap=softcap)
    return decode_attention_cuda(q, k, v, cpos, cur, window=window,
                                 softcap=softcap)
