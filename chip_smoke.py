#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero:

1. device   — requires CUDA; prints the card's name and power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/csrc`` (one
              ``nvcc`` per source, all at once).
3. kernels  — each kernel against its plain PyTorch version, f32 and bf16,
              on the reference's test cases, ragged lengths and the shapes of
              the serving path (f32 within 1e-4, bf16 within 2e-2).
4. serving  — smollm-360m at its published widths and depth, random weights
              from a seed: the kernel path against the plain path (f32), the
              engine against offline decode (f32), then a served run in bf16
              through ``Engine`` with 8 slots; the kernels' launch counts in
              that run must be > 0.
   profile  — host time against device-busy time, and the top kernels, for
              one prefill and a few decode ticks (``torch.profiler``).
5. yardstick — times each kernel, its plain version and PyTorch's
              ``scaled_dot_product_attention`` (timed only; the port never
              calls it) at the serving path's shapes, beside each kernel's
              bound: device-busy time from the profiler, and the CUDA-event
              time of the stream, which also counts host launch gaps.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARCH = "smollm-360m"
SEED = 0
MEM_RATE = 3.35e12        # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, /s
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
L2_BYTES = 50 * 2 ** 20
DEVICE = "cuda"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


# --------------------------------------------------------------------------
# 1. device, 2. build
# --------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
    print(smi, flush=True)
    return name, smi


def phase_build(_build):
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    dt = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")
    log("build", f"{sorted(_build.SOURCES)} built in {dt:.1f} s "
                 f"({len(logs)} compiled)")


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------
def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def _flash_inputs(gen, B, S, T, H, K, hd, dtype):
    q = _randn(gen, (B, S, H, hd), dtype)
    q = (q.float() * hd ** -0.5).to(dtype)            # as ops pre-scales
    return q, _randn(gen, (B, T, K, hd), dtype), _randn(gen, (B, T, K, hd),
                                                         dtype)


def _ring_positions(cur, C):
    """Slot i holds the newest position p <= cur with p % C == i, else -1."""
    cur = torch.as_tensor(cur, dtype=torch.int32, device=DEVICE)
    slot = torch.arange(C, dtype=torch.int32, device=DEVICE)[None]
    p = cur[:, None] - ((cur[:, None] - slot) % C)
    return torch.where(p >= 0, p, torch.full_like(p, -1)).to(torch.int32), cur


def _decode_inputs(gen, B, H, K, hd, C, dtype, cur=None):
    q = _randn(gen, (B, H, hd), dtype)
    q = (q.float() * hd ** -0.5).to(dtype)
    k, v = _randn(gen, (B, C, K, hd), dtype), _randn(gen, (B, C, K, hd),
                                                     dtype)
    if cur is None:     # tests/test_kernels.py: last 5 slots empty
        cpos = torch.arange(C, dtype=torch.int32, device=DEVICE)[None].repeat(
            B, 1)
        cpos[:, -5:] = -1
        cur = torch.tensor([min(40, C - 1), C - 6, 10][:B], dtype=torch.int32,
                           device=DEVICE)
    else:
        cpos, cur = _ring_positions(cur, C)
    return q, k, v, cpos, cur


def _compare(phase, label, got, want, dtype):
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.isfinite(got.float()).all()) and err <= TOL[dtype]
    log(phase, f"{label}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
               f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with plain version")
    return err


def phase_kernels(fa, dec):
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    # B, S, T, H, K, hd, causal, window, softcap, dtype
    flash_cases = [
        (2, 128, 128, 4, 2, 32, True, 0, 0.0, f32),     # test_kernels sweep
        (1, 256, 256, 4, 1, 64, True, 48, 0.0, f32),
        (2, 64, 64, 6, 6, 16, False, 0, 0.0, f32),
        (1, 128, 128, 8, 2, 64, True, 200, 0.0, f32),
        (2, 128, 128, 4, 4, 32, True, 0, 0.0, bf16),
        (1, 64, 64, 2, 1, 128, True, 32, 0.0, f32),
        (1, 64, 64, 4, 2, 32, True, 0, 20.0, f32),      # softcap
        (1, 777, 777, 15, 5, 64, True, 0, 0.0, f32),    # ragged
        (1, 1000, 1000, 15, 5, 64, True, 0, 0.0, bf16),
        (1, 1024, 1024, 15, 5, 64, True, 0, 0.0, f32),  # serving path
        (1, 1024, 1024, 15, 5, 64, True, 0, 0.0, bf16),
    ]
    errs = {}
    for (B, S, T, H, K, hd, causal, window, cap, dtype) in flash_cases:
        q, k, v = _flash_inputs(gen, B, S, T, H, K, hd, dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        err = _compare("kernels", f"flash_attention B={B} S={S} H={H} K={K} "
                                  f"hd={hd} causal={causal} window={window} "
                                  f"softcap={cap} {str(dtype)[6:]}",
                       fa.flash_attention_cuda(q, k, v, **kw),
                       fa.flash_attention_plain(q, k, v, **kw), dtype)
        errs["flash_attention"] = err     # the last case is the main path's
    # B, H, K, hd, C, window, dtype, cur
    decode_cases = [
        (3, 8, 2, 32, 64, 0, f32, None),                # test_kernels sweep
        (3, 8, 2, 32, 64, 8, f32, None),
        (3, 8, 2, 32, 128, 0, f32, None),
        (3, 8, 2, 32, 96, 24, f32, None),
        (1, 2, 1, 16, 32, 16, f32, [68]),               # ring wrap
        (8, 15, 5, 64, 2048, 0, f32,                    # serving path
         [5, 100, 1000, 2047, 2100, 3000, 4095, 5000]),
        (8, 15, 5, 64, 2048, 0, bf16,
         [5, 100, 1000, 2047, 2100, 3000, 4095, 5000]),
    ]
    for (B, H, K, hd, C, window, dtype, cur) in decode_cases:
        ins = _decode_inputs(gen, B, H, K, hd, C, dtype, cur)
        err = _compare("kernels", f"decode_attention B={B} H={H} K={K} "
                                  f"hd={hd} C={C} window={window} "
                                  f"{str(dtype)[6:]}",
                       dec.decode_attention_cuda(*ins, window=window),
                       dec.decode_attention_plain(*ins, window=window), dtype)
        errs["decode_attention"] = err
    return errs


# --------------------------------------------------------------------------
# 4. serving at full width
# --------------------------------------------------------------------------
def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def phase_correctness(cfg, M, Engine, Request):
    """f32: the kernel path against the plain path, and the engine against
    offline prefill + argmax decode."""
    params = M.init_params(cfg, SEED, dtype=torch.float32, device=DEVICE)
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, size=(1, 1008))).to(
        DEVICE, torch.int32)
    S = 1000
    kern, plain = M.Ctx(attn_impl="kernel"), M.Ctx(attn_impl="ref")
    lk, sk = M.prefill(cfg, params, toks[:, :S], 2048, kern)
    lp, sp = M.prefill(cfg, params, toks[:, :S], 2048, plain)
    worst = _rel(lk, lp)
    for i in range(S, S + 8):              # teacher-forced decode
        lk, sk = M.decode_step(cfg, params, toks[:, i], sk, kern)
        lp, sp = M.decode_step(cfg, params, toks[:, i], sp, plain)
        worst = max(worst, _rel(lk, lp))
    ok = worst < 1e-3 and bool(torch.isfinite(lk).all())
    log("serving", f"f32 kernel path vs plain path, prefill S={S} + 8 decode "
                   f"steps: max |diff| / max |logit| = {worst:.3e} (tol 1e-3) "
                   f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel path disagrees with the plain path")

    prompt = toks[0, :300]
    eng = Engine(cfg, params, batch_slots=1, cache_len=2048, ctx=kern,
                 device=DEVICE)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    got = eng.run_to_completion()[0].tokens
    lg, st = M.prefill(cfg, params, prompt[None], 2048, kern)
    want = [int(lg[0].argmax())]
    for _ in range(7):
        lg, st = M.decode_step(cfg, params, torch.tensor(
            [want[-1]], dtype=torch.int32, device=DEVICE), st, kern)
        want.append(int(lg[0].argmax()))
    log("serving", f"f32 Engine(batch_slots=1) tokens {got} vs offline "
                   f"{want}: {'ok' if got == want else 'FAIL'}")
    if got != want:
        raise AssertionError("engine tokens differ from offline decode")


def phase_served(cfg, M, Engine, Request, fa, dec):
    """bf16 served run: 8 slots, cache 2048, 24 requests, one longer than
    the cache.  Returns the kernels' launch counts in this run, and the
    parameters."""
    params = M.init_params(cfg, SEED, dtype=torch.bfloat16, device=DEVICE)
    rng = np.random.RandomState(SEED + 1)
    lengths = rng.randint(64, 1537, size=24)
    lengths[5] = 2100                         # drives fill_cache's rotation
    budgets = rng.randint(16, 65, size=24)
    eng = Engine(cfg, params, batch_slots=8, cache_len=2048,
                 dtype=torch.bfloat16, device=DEVICE)
    for uid, (n, new) in enumerate(zip(lengths, budgets)):
        prompt = torch.from_numpy(rng.randint(0, cfg.vocab, size=n)).to(
            torch.int32)
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=int(new)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = dec.launches = 0
    t0 = time.perf_counter()
    fins = eng.run_to_completion()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {"flash_attention": fa.launches,
              "decode_attention": dec.launches}
    ntok = sum(len(f.tokens) for f in fins)
    by_uid = {f.uid: f.tokens for f in fins}
    ok = (sorted(by_uid) == list(range(24))
          and all(len(by_uid[u]) == budgets[u] for u in by_uid)
          and all(0 <= t < cfg.padded_vocab for f in fins for t in f.tokens)
          and all(c > 0 for c in counts.values()))
    pre, tick = eng.timings["prefill"], eng.timings["decode"]
    log("serving", f"bf16 served {len(fins)} requests (prompts "
                   f"{lengths.min()}-{lengths.max()} tokens, max_new "
                   f"{budgets.min()}-{budgets.max()}), {ntok} tokens in "
                   f"{dt:.3f} s = {ntok / dt:.1f} tok/s")
    log("serving", f"prefill {1e3 * np.mean(pre):.2f} ms/request mean "
                   f"({1e3 * np.median(pre):.2f} median, {len(pre)}), decode "
                   f"{1e3 * np.mean(tick):.2f} ms/tick mean "
                   f"({1e3 * np.median(tick):.2f} median, {len(tick)} ticks);"
                   f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                   f" GiB")
    log("serving", f"launches in the served run: {counts} "
                   f"({cfg.n_layers} layers: {len(pre)} prefills x "
                   f"{cfg.n_layers}, {len(tick)} ticks x {cfg.n_layers}) "
                   f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("served run incomplete or a kernel not launched")
    return counts, params


def _profile(label, fn):
    """Host time of ``fn`` (it returns its number of calls; timed to a
    synchronise, without the profiler), device-busy time from the
    profiler's kernel records of a second run, and the top kernels.  The
    idle share is taken against the unprofiled host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        return n, 1e6 * (time.perf_counter() - t0)
    timed()                                         # warm
    n, wall = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_prof = timed()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log("profile", f"{label}: host {wall / n / 1e3:.3f} ms per call; "
                       f"device time not measured (the profiler recorded no "
                       f"kernels)")
        return
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log("profile", f"{label}: host {wall / n / 1e3:.3f} ms per call "
                   f"({wall_prof / n / 1e3:.3f} under the profiler), device "
                   f"busy {busy / n / 1e3:.3f} ms per call ({len(dev) / n:.0f}"
                   f" kernels), idle share {max(0.0, 1 - busy / wall):.3f}")
    for name, us in top:
        log("profile", f"  {100 * us / busy:5.1f}%  {us / n / 1e3:.4f} ms  "
                       f"{name[:90]}")


def phase_profile(cfg, M, params):
    """Where one bf16 prefill (S=1024) and one 8-slot decode tick (cache
    2048, full) spend their time, host against device."""
    rng = np.random.RandomState(SEED + 3)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, size=(1, 1024))).to(
        DEVICE)

    def prefill():
        M.prefill(cfg, params, prompt, 2048)
        return 1
    _profile("prefill S=1024", prefill)
    state = M.init_decode_state(cfg, 8, 2048, torch.bfloat16, DEVICE)
    for c in state["caches"]["units"].values():
        c["pos"].copy_(torch.arange(2048, dtype=torch.int32, device=DEVICE))
    state["pos"].fill_(2048)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, size=8)).to(DEVICE)

    def ticks(n=5):
        for _ in range(n):
            logits, _ = M.decode_step(cfg, params, toks, state)
            logits.argmax(-1).tolist()
        return n
    _profile("decode tick B=8 C=2048", ticks)


# --------------------------------------------------------------------------
# 5. yardsticks
# --------------------------------------------------------------------------
def _time_ms(fn, arg_sets, iters=20):
    """Per call, over ``iters`` calls after a warm-up, cycling through input
    sets that together exceed the L2 cache (the serving path finds each
    layer's inputs cold).  Returns (stream ms, device ms): the first from
    CUDA events around the loop, which also counts any gaps while the host
    launches; the second from the profiler's kernel durations, the
    device-busy time alone (None if the profiler records no kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def loop():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loop()
    end.record()
    torch.cuda.synchronize()
    stream = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    return stream, (busy / iters / 1e3 if busy else None)


def _report(label, times, bound, by, nbytes, flops):
    """Print one kernel's yardsticks; return its numbers for the JSON line
    (device-busy times where the profiler measured them)."""
    def show(t):
        dev = "not measured" if t[1] is None else f"{t[1]:.4f}"
        return f"{dev} device / {t[0]:.4f} stream"
    log("yardstick", f"{label}: ms per call (device-busy / CUDA-event "
                     f"stream): kernel {show(times['ms'])}, plain "
                     f"{show(times['plain_ms'])}, sdpa "
                     f"{show(times['library_ms'])}; bound {bound:.4f} ms by "
                     f"{by} ({nbytes} bytes, {flops:.4g} flops)")
    out = {k: (t[0] if t[1] is None else t[1]) for k, t in times.items()}
    return dict(out, bound_ms=bound, bound_by=by)


def _copies(make, nbytes):
    return [make() for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]


def _bound(nbytes, flops, dtype):
    t_mem, t_ops = nbytes / MEM_RATE, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def phase_yardsticks(fa, dec, ops):
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 2)
    dt = torch.bfloat16
    out = {}

    B, S, H, K, hd = 1, 1024, 15, 5, 64
    G = H // K
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
    sets = _copies(lambda: _flash_inputs(gen, B, S, S, H, K, hd, dt), nbytes)
    sdpa_sets = [(q.transpose(1, 2), k.repeat_interleave(G, 2).transpose(1, 2),
                  v.repeat_interleave(G, 2).transpose(1, 2))
                 for q, k, v in sets]
    times = dict(
        ms=_time_ms(lambda q, k, v: fa.flash_attention_cuda(q, k, v), sets),
        plain_ms=_time_ms(lambda q, k, v: fa.flash_attention_plain(q, k, v),
                          sets, iters=5),
        library_ms=_time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=1.0), sdpa_sets))
    flops = ops.flash_attention_flops(B, S, S, H, hd, True)
    out["flash_attention"] = _report(
        f"flash_attention bf16 B={B} S={S} H={H} K={K} hd={hd} causal",
        times, *_bound(nbytes, flops, dt), nbytes, flops)

    B, C = 8, 2048
    cur = [C - 1 + 250 * b for b in range(B)]        # every slot valid
    nbytes = (2 * (2 * B * H * hd + 2 * B * C * K * hd)
              + 4 * (B * C + B))
    sets = _copies(lambda: _decode_inputs(gen, B, H, K, hd, C, dt, cur),
                   nbytes)
    sdpa_sets = [(q[:, :, None], k.repeat_interleave(G, 2).transpose(1, 2),
                  v.repeat_interleave(G, 2).transpose(1, 2),
                  ((cp >= 0) & (cp <= cu[:, None]))[:, None, None])
                 for q, k, v, cp, cu in sets]
    times = dict(
        ms=_time_ms(lambda *a: dec.decode_attention_cuda(*a), sets),
        plain_ms=_time_ms(lambda *a: dec.decode_attention_plain(*a), sets),
        library_ms=_time_ms(lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, scale=1.0), sdpa_sets))
    flops = ops.decode_attention_flops(B, C, H, hd)
    out["decode_attention"] = _report(
        f"decode_attention bf16 B={B} C={C} H={H} K={K} hd={hd}",
        times, *_bound(nbytes, flops, dt), nbytes, flops)
    return out


def main():
    name, _ = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, Request

    phase_build(_build)
    errs = phase_kernels(fa, dec)
    cfg = get_config(ARCH)
    log("serving", f"{ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
                   f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
                   f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}")
    phase_correctness(cfg, M, Engine, Request)
    torch.cuda.empty_cache()
    counts, params = phase_served(cfg, M, Engine, Request, fa, dec)
    phase_profile(cfg, M, params)
    del params
    torch.cuda.empty_cache()
    times = phase_yardsticks(fa, dec, ops)

    rows = [
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:97"),
        ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention.py:70"),
    ]
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=counts[n], max_abs_err=errs[n], **times[n])
               for n, src, rep in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
