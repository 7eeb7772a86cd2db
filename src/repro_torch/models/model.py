"""Model assembly for the dense GQA decoder (blocks ``("attn",)``).

Port of ``repro.models.model`` for the dense path.  Parameters are nested
dicts of tensors with the reference's tree: the parameters of repeated units
are stacked on a leading layer axis, as ``jax.vmap(unit_init)`` stacks them,
so a reference pytree maps onto the port leaf for leaf (``bridge``).  The
reference's ``lax.scan`` over units is a loop over that axis.  Decode caches
are stacked the same way and updated in place.

Entry points
------------
``init_params``        parameters, on the card unless ``device="cpu"``
``forward``            tokens -> logits
``init_decode_state``  empty caches for ``batch`` sequences
``prefill``            tokens -> (last-position logits, decode state)
``decode_step``        one token per sequence against the decode state
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Implementation selection: ``kernel`` runs the CUDA kernels on the card
    (their plain versions for CPU tensors), ``ref`` the plain path."""
    attn_impl: str = "kernel"        # kernel | ref


def check_supported(cfg):
    """The port runs the dense ``("attn",)`` decoder only, so far."""
    kinds = set(cfg.pattern_unit) | set(cfg.tail)
    missing = [name for name, bad in (
        (f"block kinds {sorted(kinds - {'attn'})}", kinds - {"attn"}),
        ("moe", cfg.moe is not None),
        ("encoder", cfg.encoder is not None),
        ("n_media_tokens", cfg.n_media_tokens),
        ("use_rope=False", not cfg.use_rope)) if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not yet ported to repro_torch")


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------
def _block_init(gen, cfg, dtype, device):
    return {"norm1": L.norm_params(cfg.d_model, cfg.norm_type, dtype, device),
            "norm2": L.norm_params(cfg.d_model, cfg.norm_type, dtype, device),
            "mixer": A.attn_params(gen, cfg, dtype, device),
            "ffn": L.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                                dtype, device)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg, seed=0, *, dtype=torch.float32, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``.

    Same tree, shapes and initializer moments as the reference (truncated
    normal, fan-in scaled); the numbers differ, since torch cannot replay
    ``jax.random``."""
    dev = resolve_device(device)
    check_supported(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    Vp = cfg.padded_vocab
    params = {
        "embed": L.embed_init(gen, (Vp, cfg.d_model), dtype, dev),
        "final_norm": L.norm_params(cfg.d_model, cfg.norm_type, dtype, dev),
    }
    if not cfg.tied_embeddings:
        params["unembed"] = L.embed_init(gen, (Vp, cfg.d_model), dtype, dev)
    params["units"] = {
        f"b{i}": _stack([_block_init(gen, cfg, dtype, dev)
                         for _ in range(cfg.n_units)])
        for i in range(len(cfg.pattern_unit))}
    params["tail"] = [_block_init(gen, cfg, dtype, dev) for _ in cfg.tail]
    return params


# --------------------------------------------------------------------------
# blocks and stack
# --------------------------------------------------------------------------
def _apply_block(cfg, params, x, ctx: Ctx, mode, cache=None, positions=None):
    """Pre-norm residual block.  ``cache`` is filled (prefill) or appended
    to (decode) in place."""
    h = L.apply_norm(params["norm1"], x, cfg.norm_type)
    if mode == "decode":
        y, _ = A.decode_attention(params["mixer"], h, cache, positions,
                                  cfg=cfg, impl=ctx.attn_impl)
    else:
        y, (k, v) = A.full_attention(params["mixer"], h, positions, cfg=cfg,
                                     impl=ctx.attn_impl)
        if mode == "prefill":
            A.fill_cache(cache, k, v, positions)
    x = x + y
    h2 = L.apply_norm(params["norm2"], x, cfg.norm_type)
    return x + L.apply_mlp(params["ffn"], h2, cfg.ffn_kind)


def _run_stack(cfg, params, x, ctx: Ctx, mode, caches=None, positions=None):
    """Loop over units (the reference's scan), then the tail."""
    for u in range(cfg.n_units):
        unit_p = _index(params["units"], u)
        unit_c = None if caches is None else _index(caches["units"], u)
        for i in range(len(cfg.pattern_unit)):
            x = _apply_block(cfg, unit_p[f"b{i}"], x, ctx, mode,
                             cache=None if unit_c is None else unit_c[f"b{i}"],
                             positions=positions)
    for i in range(len(cfg.tail)):
        x = _apply_block(cfg, params["tail"][i], x, ctx, mode,
                         cache=None if caches is None else caches["tail"][i],
                         positions=positions)
    return x


def _embed_tokens(cfg, params, tokens):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(cfg, params, x):
    w = params["embed"] if cfg.tied_embeddings else params["unembed"]
    return L.softcap(x @ w.T, cfg.final_softcap)


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None, :].repeat(
        B, 1)


def forward(cfg, params, tokens, ctx: Ctx = Ctx()):
    """tokens [B, S] -> logits [B, S, padded_vocab].  (The reference also
    returns MoE aux losses; the dense path has none.)"""
    check_supported(cfg)
    x = _embed_tokens(cfg, params, tokens)
    positions = _positions(*tokens.shape, x.device)
    x = _run_stack(cfg, params, x, ctx, "train", positions=positions)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    return _logits(cfg, params, x)


# --------------------------------------------------------------------------
# prefill / decode
# --------------------------------------------------------------------------
def init_decode_state(cfg, batch, cache_len, dtype, device):
    """Caches stacked like the parameters: units ``[n_units, B, C, K, hd]``
    (batch on axis 1), tail ``[B, C, K, hd]`` (batch on axis 0)."""
    units = {f"b{i}": _stack([A.init_cache(cfg, batch, cache_len, dtype,
                                           device)
                              for _ in range(cfg.n_units)])
             for i in range(len(cfg.pattern_unit))}
    tail = [A.init_cache(cfg, batch, cache_len, dtype, device)
            for _ in cfg.tail]
    return {"caches": {"units": units, "tail": tail},
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(cfg, params, tokens, cache_len, ctx: Ctx = Ctx()):
    """Run the prompt, build the decode state.  Returns (last_logits, state)."""
    check_supported(cfg)
    B, S = tokens.shape
    x = _embed_tokens(cfg, params, tokens)
    positions = _positions(B, S, x.device)
    state = init_decode_state(cfg, B, cache_len, x.dtype, x.device)
    x = _run_stack(cfg, params, x, ctx, "prefill", caches=state["caches"],
                   positions=positions)
    x = L.apply_norm(params["final_norm"], x[:, -1:, :], cfg.norm_type)
    state["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return _logits(cfg, params, x)[:, 0], state


def decode_step(cfg, params, tokens, state, ctx: Ctx = Ctx()):
    """tokens: [B] -> (logits [B, Vp], state).

    The caches in ``state`` are updated in place; the returned state is the
    same dict with ``pos`` advanced by one."""
    positions = state["pos"]
    x = _embed_tokens(cfg, params, tokens[:, None])
    x = _run_stack(cfg, params, x, ctx, "decode", caches=state["caches"],
                   positions=positions)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = _logits(cfg, params, x)
    state["pos"] = positions + 1
    return logits[:, 0], state
