#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the compiler's report;
2. K1 (flash-attention forward) against its plain PyTorch version at the
   serve shape and at ragged / windowed / offset / fp32 variants, timed
   beside its plain version, ``scaled_dot_product_attention`` and its
   bound;
3. K5 (flash-decode) the same way at the contiguous-decode shape;
4. the engine: ``repro_torch.launch.serve`` builds ServeEngine +
   ModelBackend for smollm-360m at full width (bf16, seeded random
   weights) and serves 12 Poisson requests with 2100-3000-token prompts
   twice — ample page pool, then a tight one that forces evictions
   through the spill file — and the two token streams must agree;
5. contiguous-cache serving: ``LanguageModel.prefill`` on 4 prompts of
   2560 tokens, then 32 ``decode_step``s;
6. a 2-layer full-width fp32 model on the card against the same weights
   on the CPU (plain versions), prefill plus 3 decode steps.

Counters on the kernel wrappers are zeroed just before phases 4 and 5
and read just after: every kernel of the path must have launched.  The
line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero without a CUDA device
or without the package beside it.  ``--report PATH`` also writes every
number of the run as JSON to PATH.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# bf16 results of two fp32 computations that differ only in summation
# order and the final rounding: one bf16 ulp is 2^-8 of |x| <= ~4 here;
# fp32: summation order alone
TOL = {torch.bfloat16: (2e-2, 2e-3), torch.float32: (1e-4, 1e-5)}


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


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


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
    t = time.perf_counter()
    k1 = phase_k1(flush)
    k5 = phase_k5(flush)
    timings["kernels_s"] = time.perf_counter() - t
    del flush
    t = time.perf_counter()
    eng_a, eng_t = phase_engine()
    timings["engine_s"] = time.perf_counter() - t
    t = time.perf_counter()
    contig = phase_contiguous()
    timings["contiguous_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ref_err = phase_reference()
    timings["reference_s"] = time.perf_counter() - t

    k1["launches_by_phase"] = {"engine_ample": eng_a["k1_launches"],
                               "engine_tight": eng_t["k1_launches"],
                               "contiguous": contig["k1_launches"]}
    k5["launches_by_phase"] = {"engine_ample": eng_a["k5_launches"],
                               "engine_tight": eng_t["k5_launches"],
                               "contiguous": contig["k5_launches"]}
    for k in (k1, k5):
        k["launches"] = sum(k["launches_by_phase"].values())
    if not (k1["launches"] > 0 and k5["launches"] > 0):
        raise AssertionError("a kernel of the main path never launched")
    name = torch.cuda.get_device_name(0)
    report = {"device": smi, "kernels": [k1, k5], "engine_ample": eng_a,
              "engine_tight": eng_t, "contiguous": contig,
              "reference_max_abs_err": ref_err, "phase_s": timings}
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(f"phases (s): {json.dumps(timings)}")
    print(json.dumps({"kernels": [k1, k5]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
