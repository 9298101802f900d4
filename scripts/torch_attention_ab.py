"""Time the attention kernels K1, K1-lse, K5, K4f, K4f-lse and K4b of
whichever ``repro_torch`` is first on ``sys.path``, so that two trees
can be compared on one card in one run.

    PYTHONPATH=<tree>/src python scripts/torch_attention_ab.py LABEL OUT
        [--zamba2] [--absorbed | --tiled] [--host] [--train-step]

Appends one JSON line to OUT: LABEL, the package's path, and per timed
shape of ``chip_smoke.py`` (``K1_TIMED``, ``K1_LSE_TIMED``,
``K5_TIMED``, bf16) the kernel's [median, min, max] ms over 20 (K1) or
50 (K5) calls under both of ``chip_smoke._time_stats``'s timers: the
events around the call (``events``, every kernel row's timer) and the
same after a ~0.5 ms device spin (``device``, the device work alone).
At each ``K1_LSE_TIMED`` shape also the backward kernels K2 (dq, dk/dv)
and K3 (``k2_dq_*``, ``k2_dkv_*``, ``k3_*``, 10 calls each).
Per shape also the largest |difference| from the plain version (a shape
whose widths the tree's kernels do not take, such as MLA's (192, 128) on
a tree before it, is recorded as ``not_taken``), and per
K5 shape the host µs a call of the wrapper takes (``host_us``).  The
absorbed MLA shapes ((576, 512), ``mla_absorbed``) are timed with v
apart from k and again with v as k's first 512 columns, the route's
form (``*_k_prefix``; ``not_taken`` on a tree whose wrappers refuse that
view), with K3's dS workspace bytes where the tree has one
(``ds_workspace_bytes``).  ``--absorbed`` times those shapes alone;
``--tiled`` the shapes at the head-width pairs (64, 64) and (128, 128)
alone (no K5), with the K4 rows below at both ``MEGA_TIMED`` shapes.  At
chip_smoke's short training shape (``MEGA_TIMED["train"]``, B=64 x 256;
with ``--tiled`` also its serve shape, B=32, keyed ``mega_serve_*``)
also K4f, K4f-lse and K4b beside K1-lse, K3 and one
``scaled_dot_product_attention`` forward and backward (``mega_*``, 20
calls, 10 for the backwards), with K4f's and K4b's largest |difference|
from the plain versions: the planner's table
(``autotune.MEGA_TIMINGS``) reads K4f-lse against K1-lse and K4b
against K3 there.  With
``--zamba2``, also chip_smoke's bf16 prefill/decode consistency of
zamba2-1.2b at full width (B=4, S=2100): the largest and RMS logit gap.
With ``--host``, every row whose device median is under 1.5 ms also
holds the wrapper's host µs a call (``host_us``, ``chip_smoke._host_us``).
With ``--train-step``, also chip_smoke's smollm-360m training run
(``phase_train``: 8 steps at B=4 x 4096 through ``launch.train``), its
step times, wall and profiled step (``train_step``).
The timer, the shapes and the consistency check are chip_smoke's own,
imported after the tree's ``repro_torch``, so chip_smoke runs on that
tree.  To compare a change with its parent, unpack the parent's ``src``
into a directory that git ignores and run parent, change, change,
parent in one command; each tree builds its kernels into its own
``build/``.  Needs a CUDA card.
"""
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import repro_torch  # noqa: F401  (the tree under test, before chip_smoke)
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _both(fn, reps, flush, host=False):
    """Both timers; with ``host``, also the wrapper's host µs a call
    (``cs._host_us``) where the device median is under 1.5 ms (500 calls
    of a longer kernel would take the run's time)."""
    res = {"events": [cs._time_stats(fn, reps, flush)[k]
                      for k in ("median", "min", "max")],
           "device": [cs._time_stats(fn, reps, flush, spin=True)[k]
                      for k in ("median", "min", "max")]}
    if host and res["device"][0] < 1.5:
        res["host_us"] = cs._host_us(fn)
    return res


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _mega_rows(res, key, b, s, flush, host=False):
    """K4f, K4f-lse and K4b beside K1-lse, K3 and sdpa at (B, S), into
    ``res`` under ``key`` + the kernel's name."""
    q, k, v, do, o4, lse, delta = cs._k4_inputs(b, s, 7)
    args = (q, k, v, do, lse, delta)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                        enable_gqa=True)
    calls = {
        "k4f": (lambda: fa.flash_attention_mega_fwd(q, k, v), 20),
        "k4f_lse": (lambda: fa.flash_attention_mega_fwd(
            q, k, v, with_lse=True), 20),
        "k4b": (lambda: fa.flash_attention_mega_bwd(*args), 10),
        "k1_lse": (lambda: fa.flash_attention_fwd(q, k, v), 20),
        "k3": (lambda: fa.flash_attention_bwd_fused(*args), 10),
        "sdpa_fwd": (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
        "sdpa_bwd": (lambda: torch.autograd.grad(
            lo, (ql, kl, vl), do, retain_graph=True), 10)}
    for name, (fn, reps) in calls.items():
        res[f"{key}{name}"] = _both(fn, reps, flush, host)
    res[f"{key}k4f"]["max_abs_err"] = _err(
        fa.flash_attention_mega_fwd(q, k, v),
        fa.flash_attention_plain(q, k, v))
    res[f"{key}k4b"]["max_abs_err"] = max(
        _err(g, w) for g, w in zip(fa.flash_attention_mega_bwd(*args),
                                   fa.flash_attention_bwd_plain(
                                       q, k, v, o4, lse, do)))
    del q, k, v, do, o4, lse, delta, args, ql, kl, vl, lo
    torch.cuda.empty_cache()


def main() -> int:
    label, out = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    _build.load()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    bf = torch.bfloat16
    res = {"label": label, "src": fa.__file__}
    absorbed_only = "--absorbed" in sys.argv[3:]
    tiled_only = "--tiled" in sys.argv[3:]
    host = "--host" in sys.argv[3:]
    shapes = {**{f"k1_{n}": (*v, False) for n, v in cs.K1_TIMED.items()},
              **{f"k1_lse_{n}": (*v, 0, True)
                 for n, v in cs.K1_LSE_TIMED.items()}}
    shapes.update({f"{n}_k_prefix": v for n, v in shapes.items()
                   if n.endswith("mla_absorbed")})
    if absorbed_only:
        shapes = {n: v for n, v in shapes.items() if "mla_absorbed" in n}
    if tiled_only:   # the pairs (64, 64) and (128, 128)
        shapes = {n: v for n, v in shapes.items() if v[4] <= 128}
    for name, (b, h, kh, s, hd, hd_v, win, lse) in shapes.items():
        q, k, v = (cs._randn((b, h, s, hd), bf, 1),
                   cs._randn((b, kh, s, hd), bf, 2),
                   cs._randn((b, kh, s, hd_v), bf, 3))
        if name.endswith("_k_prefix"):   # v as k's first hd_v columns
            v = k[..., :hd_v]
        kernel = fa.flash_attention_fwd if lse else fa.flash_attention
        try:
            kernel(q, k, v, window=win)
        except ValueError as e:      # a tree whose kernels lack the widths
            res[name] = {"not_taken": str(e)}
            continue
        res[name] = _both(lambda: kernel(q, k, v, window=win), 20, flush,
                          host)
        got = fa.flash_attention(q, k, v, window=win, block_q=64)  # K1
        res[name]["max_abs_err"] = _err(
            got, fa.flash_attention_plain(q, k, v, window=win))
        if lse:
            do = cs._randn((b, h, s, hd_v), bf, 4)
            o_t, lse_t = fa.flash_attention_fwd(q, k, v)
            args = (q, k, v, do, lse_t, (do.float() * o_t.float()).sum(-1))
            stem = name[len("k1_lse_"):]
            for kname, fn in (("k2_dq", fa.flash_attention_bwd_dq),
                              ("k2_dkv", fa.flash_attention_bwd_dkv),
                              ("k3", fa.flash_attention_bwd_fused)):
                res[f"{kname}_{stem}"] = _both(lambda: fn(*args), 10, flush,
                                               host)
            plan = getattr(fa.autotune, "wide_ds_passes", None)
            if "mla_absorbed" in stem and plan is not None:
                passes = plan(b * h, s, s, 0, True, 0)
                res[f"k3_{stem}"]["ds_workspace_bytes"] = (
                    b * h * max(p[2] for p in passes)
                    * fa.autotune.WIDE_DS_PAIR_BYTES)
            del do, o_t, lse_t, args
        del q, k, v, got
        torch.cuda.empty_cache()
    if absorbed_only:
        print(json.dumps(res))
        with open(out, "a") as f:
            f.write(json.dumps(res) + "\n")
        return 0
    for name, (b, kh, g, s, hd, cur, win) in (
            () if tiled_only else cs.K5_TIMED.items()):
        q, kc, vc = (cs._randn((b, kh, g, hd), bf, 4),
                     cs._randn((b, kh, s, hd), bf, 5),
                     cs._randn((b, kh, s, hd), bf, 6))
        cur_t = torch.full((1,), cur, dtype=torch.int32, device="cuda")
        kern = lambda: fd.flash_decode(q, kc, vc, cur_t,  # noqa: E731
                                       window=win)
        res[f"k5_{name}"] = {
            **_both(kern, 50, flush), "host_us": cs._host_us(kern),
            "max_abs_err": _err(kern(), fd.flash_decode_plain(
                q, kc, vc, cur_t, window=win))}
    for shape in ("train", "serve") if tiled_only else ("train",):
        _mega_rows(res, "mega_" if shape == "train" else "mega_serve_",
                   *cs.MEGA_TIMED[shape], flush, host)
    if "--zamba2" in sys.argv[3:]:
        gap = cs._consistency("zamba2-1.2b", 4, 2100, "bfloat16", 32)
        res["zamba2_bf16"] = {k: gap[k] for k in (
            "max_logit_diff", "rms_logit_diff", "argmax_agreement")}
    if "--train-step" in sys.argv[3:]:
        del flush
        torch.cuda.empty_cache()
        info = cs.phase_train()
        res["train_step"] = {k: info[k] for k in (
            "step_ms", "wall_s", "step_profile")}
    print(json.dumps(res))
    with open(out, "a") as f:
        f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
