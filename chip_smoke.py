#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the compiler's report;
2. K1 (flash-attention forward) against its plain PyTorch version at the
   serve shape and at ragged / windowed / offset / fp32 variants, timed
   beside its plain version, ``scaled_dot_product_attention`` and its
   bound;
3. K5 (flash-decode) the same way at the contiguous-decode shape;
4. K1 with its logsumexp, K2 (dq; dk/dv) and K3 (fused backward) against
   their plain versions at the training shape (B=4, H=15, KH=5, S=4096,
   hd 64, bf16) and at ragged / window / q_offset / fp32-hd128 variants,
   K3 against K2, then timed at the training shape beside the plain
   versions, the forward and backward of one
   ``scaled_dot_product_attention`` call, and their bounds;
5. the engine: ``repro_torch.launch.serve`` builds ServeEngine +
   ModelBackend for smollm-360m at full width (bf16, seeded random
   weights) and serves 12 Poisson requests with 2100-3000-token prompts
   twice — ample page pool, then a tight one that forces evictions
   through the spill file — and the two token streams must agree;
6. contiguous-cache serving: ``LanguageModel.prefill`` on 4 prompts of
   2560 tokens, then 32 ``decode_step``s;
7. a 2-layer full-width fp32 model on the card against the same weights
   on the CPU (plain versions), prefill plus 3 decode steps;
8. training: ``repro_torch.launch.train`` trains smollm-360m at full
   width for 8 steps of 4 x 4096 tokens (bf16 compute, fp32 master
   weights, remat per layer); the cross entropy must fall, and K1 with
   lse must launch twice a layer and K3 once a layer per step; a
   ``torch.profiler`` breakdown of one step;
9. restart in deterministic mode (K2 backward): 8 uninterrupted steps
   against a run that checkpoints at step 4 and fail-stops at 6, resumed
   from the checkpoint — the final parameters must be equal bit for bit;
10. serving from that checkpoint: prefill 2100 tokens (K1), 16 decode
    steps (K5);
11. one train step of a 2-layer full-width fp32 model on the card (K1
    with lse, K3) against the CPU's plain path: loss, grad norm and the
    updated parameters.

Counters on the kernel wrappers are zeroed just before each main-path
phase (5, 6, 8, 9, 10) and read just after: every kernel of the path
must have launched.  The line before the last is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``.  Exits nonzero
without a CUDA device or without the package beside it.  ``--report
PATH`` also writes every number of the run as JSON to PATH.
"""
import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reads this when CUDA starts: the deterministic-restart phase
# needs it for torch.use_deterministic_algorithms(True)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.optim import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.optim.adamw import iter_leaves  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# bf16 results of two fp32 computations that differ only in summation
# order and the final rounding: one bf16 ulp is 2^-8 of |x| <= ~4 here;
# fp32: summation order alone
TOL = {torch.bfloat16: (2e-2, 2e-3), torch.float32: (1e-4, 1e-5)}
# backward and lse, relative to the largest / mean |value| of the plain
# result (gradients grow with the sequence): bf16 outputs of fp32 sums
# round once (2^-9 relative, a quarter ulp on average), fp32 differ in
# summation order over up to 4096 terms
TOL_REL = {torch.bfloat16: (1e-2, 4e-3), torch.float32: (1e-4, 1e-5)}


def _randn(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _time_ms(fn, reps, flush):
    """Mean device time of ``fn`` over ``reps`` calls, each after a write
    of a buffer larger than L2 so every call starts with a cold cache."""
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _errors(got, want):
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item()


def _check(name, got, want, dtype):
    mx, mean = _errors(got, want)
    lim_max, lim_mean = TOL[dtype]
    print(f"  {name}: max_abs_err {mx:.3e} mean_abs_err {mean:.3e} "
          f"(limits {lim_max:g}, {lim_mean:g})")
    if not (mx <= lim_max and mean <= lim_mean):
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return mx


def _check_rel(name, got, want, dtype):
    mx, mean = _errors(got, want)
    wa = want.float().abs()
    lim_max, lim_mean = TOL_REL[dtype]
    print(f"  {name}: max_abs_err {mx:.3e} mean_abs_err {mean:.3e} "
          f"(limits {lim_max:g} x max|want| {wa.max().item():.3g}, "
          f"{lim_mean:g} x mean|want| {wa.mean().item():.3g})")
    if not (mx <= lim_max * wa.max().item()
            and mean <= lim_mean * wa.mean().item()):
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return mx, mean


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _profile(fn, reps):
    """Host wall time and device kernel time per call of ``fn`` under
    ``torch.profiler`` (after one warm call), with the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms if busy_ms > 0 else None,
            "top_kernels": [[e.key[:70], e.self_device_time_total / 1e3 / reps,
                             e.count // reps] for e in top]}


def _print_profile(name, prof, wall_ms):
    """Idle share of the device over ``wall_ms``, a host wall time of the
    same call taken without the profiler where the caller has one."""
    busy = prof["device_busy_ms"]
    if busy is None:
        print(f"  profile {name}: device time not measured (no CUDA events)")
        return
    prof["idle_share"] = max(0.0, 1.0 - busy / wall_ms)
    print(f"  profile {name}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms,"
          f" idle share {prof['idle_share']:.3f}; top kernels "
          + "; ".join(f"{k} {t:.3f} ms x{c}" for k, t, c in prof["top_kernels"]))


def _live_pairs(sq, sk, q_offset, causal, window):
    """(query, key) pairs the mask keeps: the work this input needs."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


# ------------------------------------------------------------------- phases

def phase_k1(flush):
    print("== K1 flash_attention: kernel vs plain version")
    cases = [  # name, B, H, KH, Sq, Sk, hd, dtype, window, q_offset
        ("serve 3008 bf16 causal", 1, 15, 5, 3008, 3008, 64, torch.bfloat16, 0, 0),
        ("ragged Sk 3001", 1, 15, 5, 3001, 3001, 64, torch.bfloat16, 0, 0),
        ("window 512", 1, 15, 5, 3008, 3008, 64, torch.bfloat16, 512, 0),
        ("q_offset 1024", 1, 15, 5, 1984, 3008, 64, torch.bfloat16, 0, 1024),
        ("fp32 hd128", 2, 8, 2, 1100, 1100, 128, torch.float32, 0, 0),
    ]
    worst = 0.0
    for i, (name, b, h, kh, sq, sk, hd, dt, win, off) in enumerate(cases):
        q = _randn((b, h, sq, hd), dt, 10 * i)
        k = _randn((b, kh, sk, hd), dt, 10 * i + 1)
        v = _randn((b, kh, sk, hd), dt, 10 * i + 2)
        got = fa.flash_attention(q, k, v, off, causal=True, window=win)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, off, causal=True, window=win)
        worst = max(worst, _check(name, got, want, dt))

    b, h, kh, s, hd, dt = 1, 15, 5, 3008, 64, torch.bfloat16
    q, k, v = (_randn((b, h, s, hd), dt, 0), _randn((b, kh, s, hd), dt, 1),
               _randn((b, kh, s, hd), dt, 2))
    ms = _time_ms(lambda: fa.flash_attention(q, k, v), 20, flush)
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v), 5, flush)
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20, flush)
    flops = 4 * hd * h * b * _live_pairs(s, s, 0, True, 0)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    print(f"  serve shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return {"name": "flash_attention (K1)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:134",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": bound_by, "library_ms": lib_ms,
            "timed_shape": "B=1 H=15 KH=5 Sq=Sk=3008 hd=64 bf16 causal"}


def phase_k5(flush):
    print("== K5 flash_decode: kernel vs plain version")
    b, kh, g, s, hd, dt = 4, 5, 3, 2624, 64, torch.bfloat16
    q = _randn((b, kh, g, hd), dt, 100)
    kc, vc = _randn((b, kh, s, hd), dt, 101), _randn((b, kh, s, hd), dt, 102)
    worst = 0.0
    for cur in (2561, 2600):
        for win in (0, 512):
            cur_t = torch.full((1,), cur, dtype=torch.int32, device="cuda")
            got = fd.flash_decode(q, kc, vc, cur_t, window=win)
            torch.cuda.synchronize()
            want = fd.flash_decode_plain(q, kc, vc, cur_t, window=win)
            worst = max(worst, _check(f"cur {cur} window {win}", got, want, dt))
    qf = _randn((2, 2, 4, 128), torch.float32, 103)
    kf, vf = (_randn((2, 2, 700, 128), torch.float32, 104),
              _randn((2, 2, 700, 128), torch.float32, 105))
    cur_t = torch.full((1,), 641, dtype=torch.int32, device="cuda")
    _check("fp32 hd128 cur 641", fd.flash_decode(qf, kf, vf, cur_t),
           fd.flash_decode_plain(qf, kf, vf, cur_t), torch.float32)

    cur = 2600
    cur_t = torch.full((1,), cur, dtype=torch.int32, device="cuda")
    ms = _time_ms(lambda: fd.flash_decode(q, kc, vc, cur_t), 50, flush)
    plain_ms = _time_ms(lambda: fd.flash_decode_plain(q, kc, vc, cur_t), 20,
                        flush)
    q4 = q.reshape(b, kh * g, 1, hd)
    k_live, v_live = kc[:, :, :cur], vc[:, :, :cur]
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k_live, v_live, enable_gqa=True), 50, flush)
    flops = 4 * b * kh * g * cur * hd
    nbytes = (2 * q.numel() + 2 * b * kh * cur * hd) * q.element_size()
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    print(f"  decode shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB)")
    return {"name": "flash_decode (K5)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:34",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": bound_by, "library_ms": lib_ms,
            "timed_shape": "B=4 KH=5 G=3 S=2624 cur=2600 hd=64 bf16"}


SERVE_ARGS = ["--arch", "smollm-360m", "--device", "cuda", "--requests", "12",
              "--rate", "200", "--prompt-len", "2100", "3000", "--gen", "16",
              "32", "--page-size", "64", "--max-pages", "48", "--b-cap", "8",
              "--seed", "0"]


def _engine_run(pool_pages, budget, profile=False):
    args = serve_cli.parse_args(SERVE_ARGS + ["--pool-pages", str(pool_pages),
                                              "--resident-budget", str(budget)])
    eng, reqs = serve_cli.build(args)
    bk = eng.backend
    walls = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)      # returns host values: the device has finished
            walls[name].append(time.perf_counter() - t0)
            return out
        return call

    prefill, decode = bk.prefill, bk.decode_step
    bk.prefill = timed("prefill", prefill)
    bk.decode_step = timed("decode", decode)
    fa.flash_attention.launches = 0
    fd.flash_decode.launches = 0
    t0 = time.perf_counter()
    m = eng.run(reqs)
    wall = time.perf_counter() - t0
    k1 = fa.flash_attention.launches
    vocab = bk.model.cfg.vocab_size
    for r in reqs:
        if len(r.out) != r.gen or not all(0 <= t < vocab for t in r.out):
            raise AssertionError(f"request {r.rid}: {len(r.out)} of {r.gen} "
                                 f"tokens, or a token outside the vocabulary")
    n_pre = len(walls["prefill"])
    if k1 < bk.model.cfg.num_layers * n_pre:
        raise AssertionError(f"K1 launched {k1} times for {n_pre} prefills")
    toks = sum(r.gen for r in reqs)
    info = {"pool_pages": pool_pages, "resident_budget": budget,
            "wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
            "prefills": n_pre,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "prefill_ms_mean": 1e3 * float(np.mean(walls["prefill"])),
            "prefill_ms_median": 1e3 * float(np.median(walls["prefill"])),
            "decode_steps": len(walls["decode"]),
            "decode_step_ms_mean": 1e3 * float(np.mean(walls["decode"])),
            "decode_step_ms_median": 1e3 * float(np.median(walls["decode"])),
            "evictions": m["evictions"], "resumes": m["resumes"],
            "spilled_objects": m["spilled_objects"], "k1_launches": k1,
            "k5_launches": fd.flash_decode.launches}
    print(f"  pool {pool_pages} budget {budget}: {toks} tokens in "
          f"{wall:.2f} s wall ({info['tok_per_s']:.1f} tok/s); prefill "
          f"{info['prefill_ms_mean']:.1f} ms/request (median "
          f"{info['prefill_ms_median']:.1f}); decode step "
          f"{info['decode_step_ms_mean']:.2f} ms (median "
          f"{info['decode_step_ms_median']:.2f}, {len(walls['decode'])} "
          f"steps); evictions {m['evictions']:.0f} resumes "
          f"{m['resumes']:.0f} spilled {m['spilled_objects']:.0f}; K1 "
          f"launches {k1}")
    if profile:   # one full-shape step of each kind; writes no live page
        req = dataclasses.replace(reqs[0], prompt=np.arange(3000) % 512,
                                  out=[])
        info["prefill_profile"] = _profile(lambda: prefill(0, req, []), 2)
        _print_profile("engine prefill (3000 tokens)", info["prefill_profile"],
                       info["prefill_profile"]["profiled_wall_ms"])
        info["decode_profile"] = _profile(lambda: decode(
            eng.page_table, eng.cur_lens, eng.active, eng.tokens, eng.rids), 3)
        _print_profile("engine paged decode step (B=8)",
                       info["decode_profile"], info["decode_step_ms_median"])
    outs = [list(r.out) for r in reqs]
    del eng, bk
    torch.cuda.empty_cache()
    return outs, info


def phase_engine():
    print("== engine: smollm-360m full width, bf16, 12 requests")
    ample, info_a = _engine_run(384, 0, profile=True)
    tight, info_t = _engine_run(120, 2)
    if not info_t["evictions"] > 0:
        raise AssertionError("the tight pool forced no eviction")
    if ample != tight:
        raise AssertionError("token streams differ through eviction")
    print("  token streams identical with and without eviction")
    return info_a, info_t


def phase_contiguous():
    print("== contiguous: prefill 4 x 2560, then 32 decode steps")
    cfg = dataclasses.replace(get_config("smollm-360m"), param_dtype="bfloat16")
    model = LanguageModel(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    b, s, steps = 4, 2560, 32
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    fa.flash_attention.launches = 0
    fd.flash_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cache = model.alloc_cache(b, s + 64, init=cache)
    tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode_step(params, cache, tok, s + i)
        tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    k1, k5 = fa.flash_attention.launches, fd.flash_decode.launches
    if logits.shape != (b, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("decode logits are not finite (B, V)")
    if k1 != cfg.num_layers or k5 != cfg.num_layers * steps:
        raise AssertionError(f"K1 {k1} / K5 {k5} launches, want "
                             f"{cfg.num_layers} / {cfg.num_layers * steps}")
    print(f"  prefill {prefill_ms:.1f} ms (B=4 x 2560), decode step "
          f"{step_ms:.3f} ms (B=4, cache 2624); K1 launches {k1}, K5 "
          f"launches {k5}")
    prof = _profile(lambda: model.decode_step(params, cache, tok, s + steps), 3)
    _print_profile("contiguous decode step (B=4)", prof, step_ms)
    del model, params, cache
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "k1_launches": k1, "k5_launches": k5, "decode_profile": prof}


def phase_reference():
    print("== reference: 2-layer full-width fp32, card vs CPU plain path")
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    gpu, cpu = LanguageModel(cfg, device="cuda"), LanguageModel(cfg, "cpu")
    params = gpu.init(torch.Generator(device="cuda").manual_seed(3))
    params_cpu = _tree_to(params, "cpu")
    s = 2100                                   # > 2048: prefill runs K1
    rng = np.random.RandomState(4)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, s)))
    worst = 0.0
    fa.flash_attention.launches = 0
    fd.flash_decode.launches = 0
    lg, cg = gpu.prefill(params, {"tokens": tokens.cuda()})
    lc, cc = cpu.prefill(params_cpu, {"tokens": tokens})
    worst = max(worst, (lg.cpu() - lc).abs().max().item())
    cg, cc = gpu.alloc_cache(1, s + 3, init=cg), cpu.alloc_cache(1, s + 3, init=cc)
    for i in range(3):
        tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 1)))
        lg, cg = gpu.decode_step(params, cg, tok.cuda(), s + i)
        lc, cc = cpu.decode_step(params_cpu, cc, tok, s + i)
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
    if fa.flash_attention.launches != 2 or fd.flash_decode.launches != 6:
        raise AssertionError("the reference check did not run the kernels")
    print(f"  logits max_abs_err {worst:.3e} (limit 1e-3; fp32, logits O(1))")
    if not worst <= 1e-3:
        raise AssertionError("card and CPU disagree")
    return worst


# ------------------------------------------------------- training phases

COUNTERS = (fa.flash_attention, fa.flash_attention_fwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_fused, fd.flash_decode)


def _zero_counts():
    for fn in COUNTERS:
        fn.launches = 0


def _counts():
    return {"k1": fa.flash_attention.launches,
            "k1_lse": fa.flash_attention_fwd.launches,
            "k2_dq": fa.flash_attention_bwd_dq.launches,
            "k2_dkv": fa.flash_attention_bwd_dkv.launches,
            "k3": fa.flash_attention_bwd_fused.launches,
            "k5": fd.flash_decode.launches}


def phase_k_train(flush):
    """K1 with lse, K2 (dq, dk/dv) and K3 against their plain versions,
    then timed at the training shape."""
    print("== K1-lse, K2, K3: kernels vs plain versions")
    cases = [  # name, B, H, KH, Sq, Sk, hd, dtype, window, q_offset
        ("train 4x4096 bf16 causal", 4, 15, 5, 4096, 4096, 64,
         torch.bfloat16, 0, 0),
        ("ragged 4097", 1, 15, 5, 4097, 4097, 64, torch.bfloat16, 0, 0),
        ("window 512", 1, 15, 5, 4096, 4096, 64, torch.bfloat16, 512, 0),
        ("q_offset 1024", 1, 15, 5, 3072, 4096, 64, torch.bfloat16, 0, 1024),
        ("fp32 hd128", 2, 8, 2, 1100, 1100, 128, torch.float32, 0, 0),
    ]
    worst = {k: [0.0, 0.0] for k in ("k1_lse", "k2_dq", "k2_dkv", "k3")}

    def note(key, err):
        worst[key] = [max(worst[key][0], err[0]), max(worst[key][1], err[1])]

    for i, (name, b, h, kh, sq, sk, hd, dt, win, off) in enumerate(cases):
        q = _randn((b, h, sq, hd), dt, 200 + 10 * i)
        k = _randn((b, kh, sk, hd), dt, 201 + 10 * i)
        v = _randn((b, kh, sk, hd), dt, 202 + 10 * i)
        do = _randn((b, h, sq, hd), dt, 203 + 10 * i)
        kw = dict(causal=True, window=win)
        out, lse = fa.flash_attention_fwd(q, k, v, off, **kw)
        torch.cuda.synchronize()
        want_o, want_lse = fa.flash_attention_plain(q, k, v, off,
                                                    with_lse=True, **kw)
        _check(f"{name} K1-lse out", out, want_o, dt)
        note("k1_lse", _errors(lse, want_lse))
        _check(f"{name} K1-lse lse", lse, want_lse, torch.float32)
        del want_o, want_lse
        delta = (do.float() * out.float()).sum(-1)
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, off, **kw)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, off,
                                              **kw)
        dq3, dk3, dv3 = fa.flash_attention_bwd_fused(q, k, v, do, lse, delta,
                                                     off, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, off,
                                            causal=True, window=win)
        note("k2_dq", _check_rel(f"{name} K2 dq", dq2, want[0], dt))
        e_k = _check_rel(f"{name} K2 dk", dk2, want[1], dt)
        e_v = _check_rel(f"{name} K2 dv", dv2, want[2], dt)
        note("k2_dkv", (max(e_k[0], e_v[0]), max(e_k[1], e_v[1])))
        e3 = [_check_rel(f"{name} K3 {n}", g, w, dt)
              for n, g, w in zip(("dq", "dk", "dv"), (dq3, dk3, dv3), want)]
        note("k3", (max(e[0] for e in e3), max(e[1] for e in e3)))
        # one code path for dk/dv; dq summed with atomics in another order
        if not (torch.equal(dk2, dk3) and torch.equal(dv2, dv3)):
            raise AssertionError(f"{name}: K3 dk/dv differ from K2's")
        d = (dq3.float() - dq2.float()).abs()
        lim = ((2.0 ** -7 if dt == torch.bfloat16 else 1e-5)
               * dq2.float().abs() + 1e-4 * dq2.float().abs().max())
        print(f"  {name} K3 vs K2: dk, dv bit-equal; dq max_abs_diff "
              f"{d.max().item():.3e} (limit 2^-7|dq| + 1e-4 max|dq| in "
              f"bf16, 1e-5|dq| + 1e-4 max|dq| in fp32)")
        if (d > lim).any():
            raise AssertionError(f"{name}: K3 dq differs from K2's")
        del want, dq2, dk2, dv2, dq3, dk3, dv3
        torch.cuda.empty_cache()

    # timing at the training shape
    b, h, kh, s, hd, dt = 4, 15, 5, 4096, 64, torch.bfloat16
    q, k, v, do = (_randn((b, h, s, hd), dt, 300), _randn((b, kh, s, hd), dt, 301),
                   _randn((b, kh, s, hd), dt, 302), _randn((b, h, s, hd), dt, 303))
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    ms = {"k1_lse": _time_ms(lambda: fa.flash_attention_fwd(q, k, v), 10,
                             flush),
          "k2_dq": _time_ms(lambda: fa.flash_attention_bwd_dq(*args), 5,
                            flush),
          "k2_dkv": _time_ms(lambda: fa.flash_attention_bwd_dkv(*args), 5,
                             flush),
          "k3": _time_ms(lambda: fa.flash_attention_bwd_fused(*args), 5,
                         flush)}
    plain_fwd = _time_ms(lambda: fa.flash_attention_plain(
        q, k, v, with_lse=True), 3, flush)
    plain_bwd = _time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do), 3, flush)
    lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 10, flush)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                        enable_gqa=True)
    lib_bwd = _time_ms(lambda: lo.backward(do, retain_graph=True), 10, flush)
    del ql, kl, vl, lo
    live = b * h * _live_pairs(s, s, 0, True, 0)
    el = q.element_size()
    qb, kb, rowb = q.numel() * el, k.numel() * el, b * h * s * 4
    work = {  # FLOP per live pair and head dim; bytes read once + written
        "k1_lse": (4 * hd * live, 2 * qb + 2 * kb + rowb),
        "k2_dq": (6 * hd * live, 3 * qb + 2 * kb + 2 * rowb),
        "k2_dkv": (8 * hd * live, 2 * qb + 4 * kb + 2 * rowb),
        "k3": (10 * hd * live, 3 * qb + 4 * kb + 2 * rowb),
    }
    rows = {}
    names = {"k1_lse": "K1 with lse", "k2_dq": "K2 dq", "k2_dkv": "K2 dk/dv",
             "k3": "K3 fused"}
    for key, (flops, nbytes) in work.items():
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        plain = plain_fwd if key == "k1_lse" else plain_bwd
        lib = lib_fwd if key == "k1_lse" else (lib_bwd if key == "k3"
                                               else None)
        rows[key] = {"ms": ms[key], "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": worst[key][0],
                     "mean_abs_err": worst[key][1],
                     "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        print(f"  {names[key]}: kernel {ms[key]:.4f} ms, plain {plain:.4f} "
              f"ms, library {lib if lib is None else round(lib, 4)} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB)")
    print(f"  sdpa backward (dq, dk, dv: the K2 pair's work) "
          f"{lib_bwd:.4f} ms; K2 pair {ms['k2_dq'] + ms['k2_dkv']:.4f} ms")
    rows["library_bwd_ms"] = lib_bwd
    return rows


TRAIN_ARGS = ["--arch", "smollm-360m", "--data", "markov", "--batch", "4",
              "--seq", "4096", "--steps", "8", "--lr", "1e-3",
              "--device", "cuda"]


def phase_train():
    """Full-width training through the entry point, 8 steps."""
    print("== train: repro_torch.launch.train " + " ".join(TRAIN_ARGS))
    args = train_cli.parse_args(TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    tr, state = train_cli.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    layers, steps = tr.model.cfg.num_layers, args.steps
    for h in tr.history:
        print(f"  step {h['step']}: ce_loss {h['ce_loss']:.4f} loss "
              f"{h['loss']:.4f} grad_norm {h['grad_norm']:.3f} "
              f"{h['step_time'] * 1e3:.1f} ms")
    want = {"k1": 0, "k1_lse": 2 * layers * steps, "k2_dq": 0, "k2_dkv": 0,
            "k3": layers * steps, "k5": 0}
    print(f"  launches {counts} (want {want}: with remat='layer' K1 with "
          f"lse runs twice a layer, K3 once)")
    if counts != want:
        raise AssertionError("the train run did not launch the kernels "
                             "the reckoning says")
    first, last = tr.history[0]["ce_loss"], tr.history[-1]["ce_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"ce_loss {first} -> {last}: did not descend")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * h["step_time"] for h in tr.history]
    print(f"  {steps} steps in {wall:.1f} s wall; step median "
          f"{np.median(step_ms):.1f} ms (steps 2-8 mean "
          f"{np.mean(step_ms[1:]):.1f}); tokens/step "
          f"{args.batch * args.seq}; peak memory {peak_gb:.2f} GB")
    step_fn = tr._build()
    batch = {k: torch.from_numpy(v).cuda() for k, v in tr.data.get(0).items()}
    prof = _profile(lambda: step_fn(state, batch), 1)
    _print_profile("train step (B=4 x 4096)", prof, prof["profiled_wall_ms"])
    info = {"wall_s": wall, "step_ms": step_ms,
            "ce_loss": [h["ce_loss"] for h in tr.history],
            "grad_norm": [h["grad_norm"] for h in tr.history],
            "peak_memory_gb": peak_gb, "launches": counts,
            "step_profile": prof}
    del tr, state, step_fn, batch
    torch.cuda.empty_cache()
    return info


def _trainer(cfg, tc):
    args = train_cli.parse_args(TRAIN_ARGS)
    oc = OptimizerConfig(peak_lr=args.lr,
                         warmup_steps=max(args.steps // 20, 5),
                         total_steps=args.steps)
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, seed=0,
                           mode="markov")
    return Trainer(LanguageModel(cfg, device="cuda"), oc, data, tc)


def _n_params(cfg):
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    layer = (2 * d * (cfg.num_heads + cfg.num_kv_heads) * hd
             + 2 * d + 3 * d * f)
    return cfg.vocab_size * d + d + cfg.num_layers * layer


def phase_restart(ckpt_dir):
    """Deterministic mode (K2 backward): 8 uninterrupted steps against 6
    steps that checkpoint at 4 and die at 6, resumed from 4."""
    print("== restart: deterministic mode, full width, bit-exact")
    cfg = get_config("smollm-360m")
    state_bytes = 12 * _n_params(cfg)     # fp32 params, m and v
    free = shutil.disk_usage(ckpt_dir).free
    cut = None
    if free < 3 * state_bytes:       # two checkpoints and room to spare
        cut = max(2, int(cfg.num_layers * free / (3 * state_bytes)))
        cfg = dataclasses.replace(cfg, num_layers=cut)
    print(f"  checkpoint of the train state {state_bytes / 1e9:.2f} GB, "
          f"{free / 1e9:.1f} GB free at {ckpt_dir}; depth "
          f"{cfg.num_layers}{' (cut for disk space)' if cut else ''}")
    torch.use_deterministic_algorithms(True)
    try:
        _zero_counts()
        tr_a = _trainer(cfg, TrainerConfig())
        gen = torch.Generator(device="cuda")
        state_a = tr_a.run(tr_a.init_or_restore(gen.manual_seed(0)), 8)
        final_a = [p.cpu() for _p, p in iter_leaves(state_a["params"])]
        del state_a, tr_a
        torch.cuda.empty_cache()

        tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=4, async_ckpt=False,
                           fail_at_step=6)
        tr_b = _trainer(cfg, tc)
        t0 = time.perf_counter()
        tr_b.run(tr_b.init_or_restore(gen.manual_seed(0)), 8)
        b_s = time.perf_counter() - t0
        if max(h["step"] for h in tr_b.history) != 5:
            raise AssertionError("run B did not die at step 6")
        del tr_b
        torch.cuda.empty_cache()

        tr_c = _trainer(cfg, TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=4,
                                           async_ckpt=False))
        t0 = time.perf_counter()
        state_c = tr_c.init_or_restore(gen.manual_seed(99))
        restore_s = time.perf_counter() - t0
        if tr_c.start_step != 4:
            raise AssertionError(f"resumed at {tr_c.start_step}, not 4")
        state_c = tr_c.run(state_c, 8 - tr_c.start_step)
        counts = _counts()
    finally:
        torch.use_deterministic_algorithms(False)
    final_c = [p.cpu() for _p, p in iter_leaves(state_c["params"])]
    same = all(torch.equal(a, c) for a, c in zip(final_a, final_c))
    steps = 8 + 6 + 4
    print(f"  C's final params equal A's bit for bit: {same}; run B "
          f"{b_s:.1f} s (6 steps, one checkpoint), restore {restore_s:.1f} "
          f"s; launches {counts}")
    if not same:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    if not (counts["k2_dq"] == counts["k2_dkv"] == cfg.num_layers * steps
            and counts["k3"] == 0):
        raise AssertionError("deterministic mode did not run K2 alone")
    del state_c, tr_c
    torch.cuda.empty_cache()
    return {"bit_exact": same, "launches": counts, "run_b_s": b_s,
            "restore_s": restore_s, "num_layers": cfg.num_layers,
            "depth_cut_for_disk": cut, "state_gb": state_bytes / 1e9}


def phase_serve_ckpt(ckpt_dir):
    """Restore the restart phase's last checkpoint; prefill a 2100-token
    prompt (K1) and decode 16 tokens (K5) on the card."""
    print("== serve from the checkpoint: prefill 2100 tokens, 16 decodes")
    tree, step = ckpt.restore(ckpt_dir)
    n_layers = tree["params"]["layers"]["attn"]["w_q"].shape[0]
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=n_layers)
    model = LanguageModel(cfg, device="cuda")
    params = state_from_numpy(tree["params"], "cuda")
    del tree
    rng = np.random.RandomState(5)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 2100))).cuda()
    _zero_counts()
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
        cache = model.alloc_cache(1, 2100 + 16, init=cache)
        tok = logits.argmax(-1, keepdim=True)
        for i in range(16):
            logits, cache = model.decode_step(params, cache, tok, 2100 + i)
            tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    counts = _counts()
    print(f"  restored step {step}; launches {counts}")
    if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("logits from the checkpoint are not finite")
    if counts["k1"] != n_layers or counts["k5"] != 16 * n_layers or \
            counts["k1_lse"]:
        raise AssertionError("serving did not run K1 (no lse) and K5")
    del model, params, cache
    torch.cuda.empty_cache()
    return {"step": step, "launches": counts}


def phase_train_reference():
    """One train step of a 2-layer full-width fp32 model on the card (K1
    with lse, K3) against the CPU's plain path from the same weights."""
    print("== train reference: 2-layer full width fp32, B=1 S=2100, card "
          "vs CPU")
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    cpu = LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(6))
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (1, 2101))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    out = {}
    for dev in ("cuda", "cpu"):
        model = LanguageModel(cfg, dev)
        p = _tree_to(params, dev, copy=True)
        state = {"params": p, "opt": init_opt_state(p, oc)}
        _zero_counts()
        t0 = time.perf_counter()
        state, m = make_train_step(model, oc)(
            state, {k: v.to(dev) for k, v in batch.items()})
        m = {k: float(v) for k, v in m.items()}
        out[dev] = (state, m, _counts(), time.perf_counter() - t0)
    (sg, mg, cg, tg), (sc, mc, _cc, tc) = out["cuda"], out["cpu"]
    if cg["k1_lse"] != 4 or cg["k3"] != 2:
        raise AssertionError(f"card step launches {cg}: want K1-lse 4, K3 2")
    loss_err = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    gn_err = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
    p_max = p_mean = 0.0
    for (_p, a), (_q, c) in zip(iter_leaves(sg["params"]),
                                iter_leaves(sc["params"])):
        d = (a.cpu() - c).abs()
        p_max, p_mean = max(p_max, d.max().item()), max(p_mean,
                                                        d.mean().item())
    lr = oc.peak_lr
    print(f"  loss {mg['loss']:.6f} vs {mc['loss']:.6f} (rel err "
          f"{loss_err:.2e}, limit 1e-5); grad_norm {mg['grad_norm']:.5f} vs "
          f"{mc['grad_norm']:.5f} (rel err {gn_err:.2e}, limit 1e-4); "
          f"params after the step max_abs_err {p_max:.3e} (limit 2 lr = "
          f"{2 * lr:g}), worst leaf mean {p_mean:.3e} (limit 1e-4 lr); "
          f"card {tg:.1f} s, CPU {tc:.1f} s")
    if not (loss_err <= 1e-5 and gn_err <= 1e-4 and p_max <= 2 * lr
            and p_mean <= 1e-4 * lr):
        raise AssertionError("the card's train step disagrees with the CPU")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
            "param_max_abs_err": p_max, "param_worst_leaf_mean_err": p_mean,
            "launches": cg}


def _tree_to(tree, device, copy=False):
    return {k: _tree_to(v, device, copy) if isinstance(v, dict)
            else v.to(device, copy=copy) for k, v in tree.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", type=Path,
                    help="write the run's numbers as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _build.load()
    print(f"== build ({time.perf_counter() - t0:.1f} s): "
          f"{_build.library_path().name}")
    print(_build.log_path().read_text())

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    timings = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        timings[name] = time.perf_counter() - t
        return out

    k1 = timed("k1_s", phase_k1, flush)
    k5 = timed("k5_s", phase_k5, flush)
    ktrain = timed("k_train_s", phase_k_train, flush)
    del flush
    eng_a, eng_t = timed("engine_s", phase_engine)
    contig = timed("contiguous_s", phase_contiguous)
    ref_err = timed("reference_s", phase_reference)
    train = timed("train_s", phase_train)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        restart = timed("restart_s", phase_restart, ckpt_dir)
        served = timed("serve_ckpt_s", phase_serve_ckpt, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    train_ref = timed("train_reference_s", phase_train_reference)

    by_phase = {"engine_ample": {"k1": eng_a["k1_launches"],
                                 "k5": eng_a["k5_launches"]},
                "engine_tight": {"k1": eng_t["k1_launches"],
                                 "k5": eng_t["k5_launches"]},
                "contiguous": {"k1": contig["k1_launches"],
                               "k5": contig["k5_launches"]},
                "train": train["launches"], "restart": restart["launches"],
                "serve_ckpt": served["launches"]}

    def launches(*keys):
        per = {ph: sum(c.get(k, 0) for k in keys)
               for ph, c in by_phase.items()}
        return sum(per.values()), per

    k1["launches"], k1["launches_by_phase"] = launches("k1", "k1_lse")
    k1["launches_with_lse"] = launches("k1_lse")[0]
    k1["lse_at_train_shape"] = ktrain["k1_lse"]
    k5["launches"], k5["launches_by_phase"] = launches("k5")
    kernels = [k1, k5]
    src_bwd = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    for key, name, replaces in (
            ("k2_dq", "flash_attention_bwd_dq (K2 dq)",
             "src/repro/kernels/flash_attention.py:451"),
            ("k2_dkv", "flash_attention_bwd_dkv (K2 dk/dv)",
             "src/repro/kernels/flash_attention.py:494"),
            ("k3", "flash_attention_bwd_fused (K3)",
             "src/repro/kernels/flash_attention.py:541")):
        row = {"name": name, "route": "cuda", "source": src_bwd,
               "replaces": replaces, **ktrain[key],
               "timed_shape": "B=4 H=15 KH=5 S=4096 hd=64 bf16 causal"}
        row["launches"], row["launches_by_phase"] = launches(key)
        kernels.append(row)
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    name = torch.cuda.get_device_name(0)
    report = {"device": smi, "kernels": kernels, "engine_ample": eng_a,
              "engine_tight": eng_t, "contiguous": contig,
              "reference_max_abs_err": ref_err, "train": train,
              "restart": restart, "serve_ckpt": served,
              "train_reference": train_ref,
              "library_bwd_ms": ktrain["library_bwd_ms"], "phase_s": timings}
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(f"phases (s): {json.dumps(timings)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
