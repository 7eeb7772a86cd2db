"""The port's model (``repro_torch.models``) against the JAX package's, on
the CPU, with the reference's parameters copied across by ``bridge``.

Configs: reduced smollm-360m with 6 query heads over 2 kv heads, so that
G = 3 as in the published model, reduced qwen2-0.5b for ``qkv_bias``, and
the reduced smollm with every other option of the dense decoder turned on.
The JAX side runs both its plain path (``xla_rect``) and the Pallas kernels
in interpret mode (``pallas``); the port runs ``ref`` and ``kernel`` (the
kernels' plain versions on CPU tensors).  Tolerance 1e-4 on f32 logits: the
two packages sum in different orders through two layers, and the observed
gap is ~3e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import scaled_down as jax_scaled_down
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config, scaled_down
from repro_torch.models import layers as L
from repro_torch.models import model as M

TOL = 1e-4
# name -> (arch, overrides of the reduced config).  "smollm-features" turns
# on the dense-decoder options none of the three configs uses: qk-norm,
# attention and final softcaps, embedding scale, untied embeddings.
ARCHS = {
    "smollm-360m": ("smollm-360m", dict(n_heads=6, n_kv_heads=2)),
    "qwen2-0.5b": ("qwen2-0.5b", {}),
    "smollm-features": ("smollm-360m", dict(
        n_heads=6, n_kv_heads=2, qk_norm=True, attn_softcap=20.0,
        final_softcap=30.0, embed_scale=True, tied_embeddings=False)),
}
IMPLS = [("xla_rect", "ref"), ("pallas", "kernel")]


def _configs(name):
    arch, over = ARCHS[name]
    return (jax_scaled_down(jax_config(arch), **over),
            scaled_down(get_config(arch), **over))


def _params(jcfg, seed):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    # the reference initialises biases to zero and norm scales to one
    rng = np.random.RandomState(seed)
    mixer = jp["units"]["b0"]["mixer"]
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in mixer:
            mixer[name] = mixer[name] + jnp.asarray(
                0.1 * rng.standard_normal(mixer[name].shape).astype(
                    np.float32))
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j) - t.numpy())))


@pytest.mark.parametrize("arch", ["smollm-features", "qwen2-0.5b"])
def test_init_params_tree_matches_reference(arch):
    """Same paths (as jax.tree_util.keystr spells them), shapes and dtypes;
    initializer moments of the truncated normal."""
    jcfg, cfg = _configs(arch)
    jp = jax.eval_shape(lambda k: JM.init_params(jcfg, k, jnp.float32),
                        jax.random.PRNGKey(0))
    jpaths = {jax.tree_util.keystr(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = bridge.leaf_paths(M.init_params(cfg, 0, device="cpu"))
    assert sorted(jpaths) == sorted(tp)
    for path, leaf in jpaths.items():
        assert tuple(leaf.shape) == tuple(tp[path].shape), path
        assert tp[path].dtype == torch.float32, path
    # truncated normal on [-2, 2] has std 0.8796; dense_init scales by
    # fan_in**-0.5, embed_init by 0.02
    wq = tp["['units']['b0']['mixer']['wq']"]
    assert abs(float(wq.std()) / (0.8796 * cfg.d_model ** -0.5) - 1) < 0.05
    assert abs(float(tp["['embed']"].std()) / (0.8796 * 0.02) - 1) < 0.05
    assert float(tp["['embed']"].abs().max()) <= 0.04 + 1e-7


def test_init_params_is_seeded():
    _, cfg = _configs("smollm-360m")
    a, b, c = (M.init_params(cfg, s, device="cpu") for s in (3, 3, 4))
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


def test_layers_match_reference():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32)[None], (2, 1))
    assert _err(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
                L.rope(torch.from_numpy(x), torch.from_numpy(pos),
                       10_000.0)) < 1e-5
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    for kind in ("rms", "layer"):
        p = {"scale": 1 + 0.1 * rng.standard_normal(8).astype(np.float32),
             "bias": 0.1 * rng.standard_normal(8).astype(np.float32)}
        assert _err(JL.apply_norm(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(h), kind),
                    L.apply_norm(bridge.params_from_jax(p),
                                 torch.from_numpy(h), kind)) < 1e-5
    for kind in ("swiglu", "geglu", "gelu"):
        jp = JL.mlp_params(jax.random.PRNGKey(1), 8, 12, kind, jnp.float32)
        assert _err(JL.apply_mlp(jp, jnp.asarray(h), kind),
                    L.apply_mlp(bridge.params_from_jax(
                        jax.tree.map(np.asarray, jp)),
                        torch.from_numpy(h), kind)) < 1e-5
    assert _err(JL.softcap(jnp.asarray(h) * 50, 30.0),
                L.softcap(torch.from_numpy(h) * 50, 30.0)) < 1e-4


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("jax_impl,impl", IMPLS)
def test_forward_prefill_decode_match_reference(arch, jax_impl, impl):
    jcfg, cfg = _configs(arch)
    jp, tp = _params(jcfg, 1)
    toks = _tokens(cfg, 2, 11, 2)
    jctx, ctx = JM.Ctx(attn_impl=jax_impl), M.Ctx(attn_impl=impl)

    jl, _ = JM.forward(jcfg, jp, jnp.asarray(toks), jctx)
    tl = M.forward(cfg, tp, torch.from_numpy(toks), ctx)
    assert tl.shape == (2, 11, cfg.padded_vocab)
    assert _err(jl, tl) < TOL

    n = 7
    jlg, js = JM.prefill(jcfg, jp, jnp.asarray(toks[:, :n]), 16, jctx)
    tlg, ts = M.prefill(cfg, tp, torch.from_numpy(toks[:, :n]), 16, ctx)
    assert _err(jlg, tlg) < TOL
    for i in range(n, n + 4):
        jlg, js = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, i]), js, jctx)
        tlg, ts = M.decode_step(cfg, tp, torch.from_numpy(toks[:, i]), ts,
                                ctx)
        assert _err(jlg, tlg) < TOL, i
    assert np.array_equal(np.asarray(js["pos"]), ts["pos"].numpy())


@pytest.mark.parametrize("jax_impl,impl", IMPLS)
def test_prompt_longer_than_cache_rotates_like_reference(jax_impl, impl):
    """S >= cache_len keeps the last C tokens at slot pos % C."""
    jcfg, cfg = _configs("smollm-360m")
    jp, tp = _params(jcfg, 3)
    toks = _tokens(cfg, 2, 16, 4)
    C, n = 8, 13
    jctx, ctx = JM.Ctx(attn_impl=jax_impl), M.Ctx(attn_impl=impl)
    jlg, js = JM.prefill(jcfg, jp, jnp.asarray(toks[:, :n]), C, jctx)
    tlg, ts = M.prefill(cfg, tp, torch.from_numpy(toks[:, :n]), C, ctx)
    assert _err(jlg, tlg) < TOL
    jc, tc = js["caches"]["units"]["b0"], ts["caches"]["units"]["b0"]
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    assert sorted(tc["pos"][0, 0].tolist()) == list(range(n - C, n))
    for name in ("k", "v"):
        assert _err(jc[name], tc[name]) < TOL
    for i in range(n, 16):                   # decode wraps the ring
        jlg, js = JM.decode_step(jcfg, jp, jnp.asarray(toks[:, i]), js, jctx)
        tlg, ts = M.decode_step(cfg, tp, torch.from_numpy(toks[:, i]), ts,
                                ctx)
        assert _err(jlg, tlg) < TOL, i


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_decode_matches_own_forward(impl):
    """Prefill + decode reproduce teacher-forced forward logits (2e-3, as
    tests/test_arch_smoke.py holds the reference)."""
    _, cfg = _configs("smollm-360m")
    params = M.init_params(cfg, 5, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, 6))
    ctx = M.Ctx(attn_impl=impl)
    full = M.forward(cfg, params, toks, ctx)
    n = 8
    lg, st = M.prefill(cfg, params, toks[:, :n], 32, ctx)
    assert float((lg - full[:, n - 1]).abs().max()) < 2e-3
    for i in range(n, 12):
        lg, st = M.decode_step(cfg, params, toks[:, i], st, ctx)
        assert float((lg - full[:, i]).abs().max()) < 2e-3, i


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-3b", "whisper-small",
                                  "kimi-k2-1t-a32b", "internvl2-26b"])
def test_unported_features_raise(arch):
    """Not yet ported: local/rglru/rwkv blocks, MoE, encoder, media tokens."""
    import dataclasses
    jcfg = jax_config(arch)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)
              if f.name not in ("moe", "encoder")}
    from repro_torch.configs import ArchConfig, EncoderSpec, MoESpec
    if jcfg.moe is not None:
        fields["moe"] = MoESpec(**dataclasses.asdict(jcfg.moe))
    if jcfg.encoder is not None:
        fields["encoder"] = EncoderSpec(**dataclasses.asdict(jcfg.encoder))
    cfg = scaled_down(ArchConfig(**fields))
    with pytest.raises(NotImplementedError):
        M.init_params(cfg, 0, device="cpu")
