"""The port's serving engine, on the CPU.

* Against offline prefill + argmax decode in the configuration where the
  reference engine splices the wrong axis (``n_units == batch_slots``):
  the port splices on the batch axis it knows by name.  Every offline step's
  top-2 logit margin must exceed the numeric tolerance, so that a near-tie
  cannot flip a token.
* Against the JAX engine where the reference is right (2 units, 3 slots).
* The reference's serving semantics: ``max_new_tokens=1`` emits one token,
  EOS counts on the prefill token, ``max_ticks`` raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import scaled_down as jax_scaled_down
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.configs import get_config, scaled_down
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine, EngineIncomplete, Request

MARGIN = 1e-4          # the f32 agreement of batched and unbatched logits


def _setup(seed=0):
    over = dict(n_heads=6, n_kv_heads=2, n_units=2)
    cfg = scaled_down(get_config("smollm-360m"), **over)
    return cfg, M.init_params(cfg, seed, device="cpu")


def _prompts(cfg, lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
            for n in lengths]


def _offline(cfg, params, prompt, n_new, cache_len, ctx=M.Ctx()):
    """Prefill + argmax decode for one prompt; returns tokens and the
    smallest top-2 logit margin along the way."""
    lg, st = M.prefill(cfg, params, torch.from_numpy(prompt)[None],
                       cache_len, ctx)
    toks, margin = [], float("inf")
    for _ in range(n_new):
        top2 = torch.topk(lg[0], 2).values
        margin = min(margin, float(top2[0] - top2[1]))
        toks.append(int(torch.argmax(lg[0])))
        if len(toks) == n_new:
            break
        lg, st = M.decode_step(cfg, params,
                               torch.tensor([toks[-1]], dtype=torch.int32),
                               st, ctx)
    return toks, margin


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_engine_matches_offline_when_units_equal_slots(impl):
    cfg, params = _setup()
    assert cfg.n_units == 2
    ctx = M.Ctx(attn_impl=impl)
    prompts = _prompts(cfg, [5, 9, 3, 7, 6], 1)
    budgets = [6, 4, 7, 5, 6]
    eng = Engine(cfg, params, batch_slots=2, cache_len=32, ctx=ctx,
                 device="cpu")
    for uid, (p, n) in enumerate(zip(prompts, budgets)):
        eng.submit(Request(uid=uid, prompt=torch.from_numpy(p),
                           max_new_tokens=n))
    got = {f.uid: f.tokens for f in eng.run_to_completion()}
    assert sorted(got) == list(range(5))
    for uid, (p, n) in enumerate(zip(prompts, budgets)):
        want, margin = _offline(cfg, params, p, n, 32, ctx)
        assert margin > MARGIN, (uid, margin)
        assert got[uid] == want, uid


def test_engine_matches_jax_engine():
    over = dict(n_heads=6, n_kv_heads=2, n_units=2)
    jcfg = jax_scaled_down(jax_config("smollm-360m"), **over)
    cfg = scaled_down(get_config("smollm-360m"), **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    prompts = _prompts(cfg, [6, 6, 4, 6], 8)
    jeng = JE.Engine(jcfg, jp, batch_slots=3, cache_len=16)
    teng = Engine(cfg, tp, batch_slots=3, cache_len=16, device="cpu")
    for uid, p in enumerate(prompts):
        jeng.submit(JE.Request(uid=uid, prompt=jnp.asarray(p),
                               max_new_tokens=4 + uid % 2))
        teng.submit(Request(uid=uid, prompt=torch.from_numpy(p),
                            max_new_tokens=4 + uid % 2))
    want = {f.uid: f.tokens for f in jeng.run_to_completion()}
    got = {f.uid: f.tokens for f in teng.run_to_completion()}
    assert got == want


def test_max_new_tokens_one_emits_one_token():
    cfg, params = _setup()
    p = _prompts(cfg, [5], 2)[0]
    eng = Engine(cfg, params, batch_slots=2, cache_len=16, device="cpu")
    eng.submit(Request(uid=0, prompt=torch.from_numpy(p), max_new_tokens=1))
    fins = eng.run_to_completion()
    assert [len(f.tokens) for f in fins] == [1]
    assert fins[0].tokens == _offline(cfg, params, p, 1, 16)[0]


def test_eos_on_prefill_token_finishes():
    cfg, params = _setup()
    p = _prompts(cfg, [5], 3)[0]
    first = _offline(cfg, params, p, 1, 16)[0][0]
    eng = Engine(cfg, params, batch_slots=1, cache_len=16, device="cpu")
    eng.submit(Request(uid=0, prompt=torch.from_numpy(p), max_new_tokens=8,
                       eos_id=first))
    eng.submit(Request(uid=1, prompt=torch.from_numpy(p), max_new_tokens=2))
    fins = {f.uid: f.tokens for f in eng.run_to_completion()}
    assert fins[0] == [first]
    assert len(fins[1]) == 2


def test_max_ticks_raises_with_partial_results():
    cfg, params = _setup()
    eng = Engine(cfg, params, batch_slots=1, cache_len=16, device="cpu")
    for uid, p in enumerate(_prompts(cfg, [4, 4], 4)):
        eng.submit(Request(uid=uid, prompt=torch.from_numpy(p),
                           max_new_tokens=5))
    with pytest.raises(EngineIncomplete) as info:
        eng.run_to_completion(max_ticks=3)
    assert info.value.n_queued == 1 and info.value.n_in_flight == 1
    assert info.value.finished == []


def test_engine_refuses_params_on_another_device():
    cfg, params = _setup()
    params = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError):
        Engine(cfg, params, batch_slots=1, cache_len=16, device="cpu")
