"""Which backward products of the bf16 K2/K3 need P or dS as a bf16 hi + lo
pair, emulated on the CPU in fp32.

The tensor-core K2 and K3 (``src/repro_torch/kernels/csrc/
flash_attention_bwd.cu``) feed P and dS to ``mma.sync`` as bf16.  This
script runs the plain backward of ``repro_torch.kernels.flash_attention``
with P (in dV = P^T dO) and dS (in dK = dS^T q and dQ = dS k) rounded to
bf16 — one product at a time, all three, and as a hi + lo pair — and
counts the entries of the bf16 result that fall outside the limit the
card checks hold K2 to against K4b (``tests/test_torch_cuda.py::
test_mega_backward_is_deterministic_and_matches_k2``, ``chip_smoke.py``
phase 4a): |x - ref| <= 2^-7 |x| + 1e-4 max|x|, ref the fp32 backward
rounded once to bf16.

    PYTHONPATH=src python scripts/torch_bwd_rounding.py [--batch 16]

The card's test runs B=64, H=15, KH=5, S=256, hd 64, bf16 causal; the
default here is that shape at B=16 to keep the CPU run small (every
count scales with the number of entries).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa


def _bf16(x, mode):
    """x as the mma operand: exact, one bf16 rounding, or hi + lo."""
    if mode == "fp32":
        return x
    hi = x.to(torch.bfloat16).float()
    if mode == "bf16":
        return hi
    return hi + (x - hi).to(torch.bfloat16).float()


def backward(q, k, v, do, lse, delta, p_mode, ds_k_mode, ds_q_mode):
    """The plain backward (causal, one tile of rows: S is small) with P
    and dS rounded as the modes say before their products."""
    b, h, s, hd = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = 1.0 / np.sqrt(hd)
    qf = q.float().reshape(b, kh, g, s, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, kh, g, s, hd)
    sc = torch.einsum("bkgqh,bksh->bkgqs", qf * scale, kf)
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    sc = torch.where(mask, sc, fa.NEG_INF)
    p = torch.exp(sc - lse.reshape(b, kh, g, s, 1))
    dp = torch.einsum("bkgqh,bksh->bkgqs", dof, vf)
    ds = p * (dp - delta.reshape(b, kh, g, s, 1))
    dv = torch.einsum("bkgqs,bkgqh->bksh", _bf16(p, p_mode), dof)
    dk = torch.einsum("bkgqs,bkgqh->bksh", _bf16(ds, ds_k_mode), qf) * scale
    dq = torch.einsum("bkgqs,bksh->bkgqh", _bf16(ds, ds_q_mode), kf) * scale
    return (dq.reshape(b, h, s, hd).to(torch.bfloat16),
            dk.to(torch.bfloat16), dv.to(torch.bfloat16))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=10)
    args = ap.parse_args()
    b, h, kh, s, hd = args.batch, 15, 5, 256, 64
    rng = np.random.RandomState(args.seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(torch.bfloat16)
                   for shape in ((b, h, s, hd), (b, kh, s, hd),
                                 (b, kh, s, hd), (b, h, s, hd)))
    out, lse = fa.flash_attention_plain(q, k, v, with_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    ref = backward(q, k, v, do, lse, delta, "fp32", "fp32", "fp32")
    print(f"B={b} H={h} KH={kh} S={s} hd={hd} bf16 causal: entries of "
          f"dq, dk, dv outside 2^-7|x| + 1e-4 max|x| of the fp32 backward "
          f"({q.numel()} / {k.numel()} / {v.numel()} entries)")
    for name, modes in (
            ("no rounding", ("fp32", "fp32", "fp32")),
            ("P in dV one bf16", ("bf16", "fp32", "fp32")),
            ("dS in dK one bf16", ("fp32", "bf16", "fp32")),
            ("dS in dQ one bf16", ("fp32", "fp32", "bf16")),
            ("all three one bf16", ("bf16", "bf16", "bf16")),
            ("all three hi + lo", ("pair", "pair", "pair"))):
        got = backward(q, k, v, do, lse, delta, *modes)
        bad = []
        for x, r in zip(got, ref):
            xf, rf = x.float(), r.float()
            lim = 2.0 ** -7 * xf.abs() + 1e-4 * xf.abs().max()
            bad.append(int(((xf - rf).abs() > lim).sum()))
        print(f"  {name:20s} dq {bad[0]:8d}  dk {bad[1]:8d}  dv {bad[2]:8d}")


if __name__ == "__main__":
    main()
