"""The port's attention kernels (B1 flash attention, B2 flash-decode) against
the JAX package's, on the CPU.

The JAX side runs the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them; the port's dispatchers take the plain
PyTorch versions for CPU tensors.  Inputs come from ``numpy.RandomState``
and go through both.  Tolerances, as in ``tests/test_kernels.py``: f32 2e-5
(both sides sum in f32, in different orders), bf16 2e-2 (outputs rounded to
bf16, whose spacing near 1 is 2**-7 ~ 8e-3).

The ``cuda``-marked tests hold the CUDA kernels against their plain
versions and skip without a card: a CUDA kernel has no CPU mode.  JAX is
imported inside the tests that compare with it, so that the ``cuda`` tests
also run on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

F32_TOL, BF16_TOL = 2e-5, 2e-2

# tests/test_kernels.py's sweep, plus smollm-360m's grouping (G = 3)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 32, True, 0, "float32"),
    (1, 256, 256, 4, 1, 64, True, 48, "float32"),
    (2, 64, 64, 6, 6, 16, False, 0, "float32"),
    (1, 128, 128, 8, 2, 64, True, 200, "float32"),
    (2, 128, 128, 4, 4, 32, True, 0, "bfloat16"),
    (1, 64, 64, 2, 1, 128, True, 32, "float32"),
    (1, 96, 96, 6, 2, 64, True, 0, "float32"),
    (1, 96, 96, 6, 2, 64, True, 0, "bfloat16"),
]
DECODE_CASES = [(3, 8, 2, 32, 64, 0), (3, 8, 2, 32, 64, 8),
                (3, 8, 2, 32, 128, 0), (3, 8, 2, 32, 96, 24),
                (3, 6, 2, 64, 80, 0)]           # B, H, K, hd, C, window


@pytest.fixture
def jx():
    """jax.numpy and the JAX package's kernel dispatchers."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops
    return jnp, ops


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(jnp, a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, dtype=np.float32)
                               - t.float().numpy())))


def _decode_inputs(rng, B, H, K, hd, C):
    q, k, v = (_normal(rng, s) for s in ((B, H, hd), (B, C, K, hd),
                                         (B, C, K, hd)))
    cpos = np.tile(np.arange(C, dtype=np.int32)[None], (B, 1))
    cpos[:, -5:] = -1
    cur = np.array([min(40, C - 1), C - 6, 10][:B], np.int32)
    return q, k, v, cpos, cur


def _ring_inputs(rng):
    """Ring of 32 slots holding positions 37..68 at slot p % 32."""
    B, H, K, hd, C = 1, 2, 1, 16, 32
    q, k, v = (_normal(rng, s) for s in ((B, H, hd), (B, C, K, hd),
                                         (B, C, K, hd)))
    ar = np.arange(C)
    cpos = ((ar + 64) - ((ar + 64) % C) + ar)[None]
    cpos = np.where(cpos > 68, cpos - C, cpos).astype(np.int32)
    return q, k, v, cpos, np.array([68], np.int32)


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window,dtype", FLASH_CASES)
def test_flash_attention_matches_jax(jx, B, S, T, H, K, hd, causal, window,
                                     dtype):
    jnp, jops = jx
    rng = np.random.RandomState(S + H + hd)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(jnp, _normal(rng, s), dtype)
        for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert _err(want, got) < tol


def test_flash_attention_softcap_matches_jax(jx):
    jnp, jops = jx
    rng = np.random.RandomState(7)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(jnp, _normal(rng, s), "float32")
        for s in ((1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32)))
    want = jops.flash_attention(jq, jk, jv, causal=True, softcap=20.0,
                                block_q=16, block_kv=16)
    got = tops.flash_attention(tq, tk, tv, causal=True, softcap=20.0)
    assert _err(want, got) < F32_TOL


@pytest.mark.parametrize("B,H,K,hd,C,window", DECODE_CASES)
def test_decode_attention_matches_jax(jx, B, H, K, hd, C, window):
    jnp, jops = jx
    q, k, v, cpos, cur = _decode_inputs(np.random.RandomState(C), B, H, K,
                                        hd, C)
    want = jops.decode_attention(*(jnp.asarray(a) for a in
                                   (q, k, v, cpos, cur)), window=window,
                                 block_kv=32)
    got = tops.decode_attention(*(torch.from_numpy(a) for a in
                                  (q, k, v, cpos, cur)), window=window)
    assert _err(want, got) < F32_TOL


def test_decode_attention_ring_wrap_matches_jax(jx):
    jnp, jops = jx
    ins = _ring_inputs(np.random.RandomState(3))
    want = jops.decode_attention(*(jnp.asarray(a) for a in ins), window=16,
                                 block_kv=8)
    got = tops.decode_attention(*(torch.from_numpy(a) for a in ins),
                                window=16)
    assert _err(want, got) < F32_TOL


def test_decode_attention_bf16_matches_jax(jx):
    jnp, jops = jx
    q, k, v, cpos, cur = _decode_inputs(np.random.RandomState(5), 3, 6, 2,
                                        64, 64)
    (jq, tq), (jk, tk), (jv, tv) = (_both(jnp, a, "bfloat16")
                                    for a in (q, k, v))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(cpos),
                                 jnp.asarray(cur), block_kv=32)
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(cpos),
                                torch.from_numpy(cur))
    assert got.dtype == torch.bfloat16
    assert _err(want, got) < BF16_TOL


def test_reference_oracles_match_jax(jx):
    """The port's ``ref`` module against ``repro.kernels.ref``."""
    jnp, _ = jx
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    rng = np.random.RandomState(11)
    q, k, v = (_normal(rng, s) for s in ((2, 40, 6, 32), (2, 40, 2, 32),
                                         (2, 40, 2, 32)))
    for kw in (dict(causal=True), dict(causal=False, window=9),
               dict(causal=True, softcap=5.0)):
        want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw)
        got = tref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                 **kw)
        assert _err(want, got) < F32_TOL, kw
    ins = _decode_inputs(rng, 3, 6, 2, 32, 48)
    for kw in (dict(), dict(window=12, softcap=5.0)):
        want = jref.decode_attention_ref(*(jnp.asarray(a) for a in ins), **kw)
        got = tref.decode_attention_ref(*(torch.from_numpy(a) for a in ins),
                                        **kw)
        assert _err(want, got) < F32_TOL, kw


def test_dispatchers_take_plain_version_for_cpu_tensors(monkeypatch):
    """On CPU tensors the dispatchers never reach a kernel launch."""
    def no_launch(*a, **k):
        raise AssertionError("kernel launched for a CPU tensor")
    monkeypatch.setattr(tfa, "flash_attention_cuda", no_launch)
    monkeypatch.setattr(tdec, "decode_attention_cuda", no_launch)
    before = (tfa.launches, tdec.launches)
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(_normal(rng, s))
               for s in ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    out = tops.flash_attention(q, k, v)
    assert out.shape == q.shape
    dq, dk, dv, cpos, cur = (torch.from_numpy(a) for a in
                             _decode_inputs(rng, 3, 8, 2, 32, 64))
    assert tops.decode_attention(dq, dk, dv, cpos, cur).shape == dq.shape
    assert (tfa.launches, tdec.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the launch path raises for a tensor not on the card."""
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention_cuda(torch.zeros(1, 4, 16), k, k,
                                   torch.zeros(1, 8, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32))


def test_flops_formulas_match_reference(jx):
    _, jops = jx
    for args in ((1, 1024, 1024, 15, 64, True), (2, 64, 96, 4, 32, False)):
        assert tops.flash_attention_flops(*args) == \
            jops.flash_attention_flops(*args)
    assert tops.decode_attention_flops(8, 2048, 15, 64) == \
        jops.decode_attention_flops(8, 2048, 15, 64)


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,causal,window,dtype", FLASH_CASES + [
    (1, 777, 777, 15, 5, 64, True, 0, "float32"),
    (1, 1000, 1000, 15, 5, 64, True, 0, "bfloat16"),
])
def test_flash_attention_kernel_matches_plain(cuda, B, S, T, H, K, hd,
                                              causal, window, dtype):
    rng = np.random.RandomState(S + H + hd)
    q, k, v = (torch.from_numpy(_normal(rng, s)).to(cuda,
                                                    getattr(torch, dtype))
               for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    q = q * hd ** -0.5
    got = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == "bfloat16" else 1e-4
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,hd,C,window", DECODE_CASES)
def test_decode_attention_kernel_matches_plain(cuda, B, H, K, hd, C, window):
    ins = [torch.from_numpy(a).to(cuda) for a in
           _decode_inputs(np.random.RandomState(C), B, H, K, hd, C)]
    got = tdec.decode_attention_cuda(*ins, window=window)
    want = tdec.decode_attention_plain(*ins, window=window)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.cuda
def test_decode_attention_kernel_ring_wrap(cuda):
    ins = [torch.from_numpy(a).to(cuda)
           for a in _ring_inputs(np.random.RandomState(3))]
    got = tdec.decode_attention_cuda(*ins, window=16)
    want = tdec.decode_attention_plain(*ins, window=16)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < 1e-4
