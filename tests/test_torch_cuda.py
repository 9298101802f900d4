"""Card-only checks: the CUDA kernels K1 (with and without its
logsumexp), K2, K3 and K5 against their plain PyTorch versions on the
same inputs, and a reduced train step on the card against the CPU.
They skip (from inside the fixture) where torch sees no CUDA device; on
a machine with the card run

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd

pytestmark = pytest.mark.cuda

# bf16 inputs, fp32 arithmetic on both sides: they differ only in the
# order of the sums and the final bf16 rounding of the output (one bf16
# ulp is 2^-8 relative), so 2e-2 absolute on O(1) outputs; fp32 differs
# only in summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("b,h,kh,sq,sk,hd,dtype,window,q_offset", [
    (1, 6, 2, 300, 300, 64, torch.bfloat16, 0, 0),      # ragged edge
    (2, 4, 4, 256, 256, 128, torch.bfloat16, 0, 0),     # MHA, hd 128
    (1, 15, 5, 200, 200, 64, torch.float32, 0, 0),      # fp32, G = 3
    (1, 6, 3, 333, 333, 64, torch.bfloat16, 100, 0),    # window
    (2, 8, 2, 130, 390, 64, torch.bfloat16, 0, 260),    # q stripe offset
    (1, 4, 1, 129, 257, 128, torch.float32, 64, 128),   # MQA, all of it
])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kh, sq, sk, hd,
                                              dtype, window, q_offset):
    q = _randn((b, h, sq, hd), dtype, cuda, 0)
    k = _randn((b, kh, sk, hd), dtype, cuda, 1)
    v = _randn((b, kh, sk, hd), dtype, cuda, 2)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, q_offset, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, q_offset, causal=True,
                                    window=window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("b,kh,g,s,hd,cur,window,dtype", [
    (4, 5, 3, 2624, 64, 2561, 0, torch.bfloat16),
    (4, 5, 3, 2624, 64, 2600, 512, torch.bfloat16),
    (2, 2, 4, 300, 128, 1, 0, torch.float32),
    (2, 2, 8, 256, 64, 256, 16, torch.float32),
    (1, 3, 1, 1000, 128, 777, 0, torch.bfloat16),
])
def test_flash_decode_kernel_matches_plain(cuda, b, kh, g, s, hd, cur,
                                           window, dtype):
    q = _randn((b, kh, g, hd), dtype, cuda, 3)
    kc = _randn((b, kh, s, hd), dtype, cuda, 4)
    vc = _randn((b, kh, s, hd), dtype, cuda, 5)
    cur_t = torch.full((1,), cur, dtype=torch.int32, device=cuda)
    before = fd.flash_decode.launches
    got = fd.flash_decode(q, kc, vc, cur_t, window=window)
    torch.cuda.synchronize()
    assert fd.flash_decode.launches == before + 1
    want = fd.flash_decode_plain(q, kc, vc, cur_t, window=window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 2, 8, 32), device=cuda)          # head_dim 32
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 1, 2, 64), device=cuda)
    kc = torch.zeros((1, 1, 16, 64), device=cuda)
    with pytest.raises(TypeError):                        # int64 cur_len
        fd.flash_decode(q, kc, kc, torch.ones(1, dtype=torch.int64,
                                              device=cuda))


# backward, bf16: kernel and plain version both sum in fp32 and round once
# to bf16 (2^-9 relative), so rtol 1e-2; atol covers fp32 summation order
# on near-zero sums.  fp32: summation order only.  lse is fp32 either way.
BWD_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}


def _close(got, want, tol):
    rtol, atol = tol
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    assert not bad.any(), err.max().item()


@pytest.mark.parametrize("b,h,kh,sq,sk,hd,dtype,window,q_offset", [
    (1, 6, 2, 300, 300, 64, torch.bfloat16, 0, 0),      # ragged, G = 3
    (1, 6, 3, 333, 333, 64, torch.bfloat16, 100, 0),    # window
    (2, 8, 2, 130, 390, 64, torch.bfloat16, 0, 260),    # q stripe offset
    (1, 4, 1, 129, 257, 128, torch.float32, 64, 128),   # MQA, fp32, hd 128
])
def test_flash_backward_kernels_match_plain(cuda, b, h, kh, sq, sk, hd,
                                            dtype, window, q_offset):
    q = _randn((b, h, sq, hd), dtype, cuda, 0)
    k = _randn((b, kh, sk, hd), dtype, cuda, 1)
    v = _randn((b, kh, sk, hd), dtype, cuda, 2)
    do = _randn((b, h, sq, hd), dtype, cuda, 6)
    kw = dict(causal=True, window=window)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, q_offset, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want_out, want_lse = fa.flash_attention_plain(q, k, v, q_offset,
                                                  with_lse=True, **kw)
    assert (out.float() - want_out.float()).abs().max().item() <= TOL[dtype]
    _close(lse, want_lse, (1e-5, 1e-4))

    delta = (do.float() * out.float()).sum(-1)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, q_offset, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, q_offset,
                                          **kw)
    dq3, dk3, dv3 = fa.flash_attention_bwd_fused(q, k, v, do, lse, delta,
                                                 q_offset, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, q_offset,
                                        causal=True, window=window)
    for got2, got3, w in zip((dq2, dk2, dv2), (dq3, dk3, dv3), want):
        assert got2.dtype == w.dtype and got2.shape == w.shape
        _close(got2, w, BWD_TOL[dtype])
        _close(got3, w, BWD_TOL[dtype])
    # one code path for K2's and K3's dk/dv: equal bit for bit; K3's dq
    # sums with atomics in another order (fp32), then rounds to dtype
    assert torch.equal(dk2, dk3) and torch.equal(dv2, dv3)
    _close(dq3, dq2, (2.0 ** -7, 1e-4) if dtype == torch.bfloat16
           else (1e-5, 1e-5))


def test_autograd_picks_k3_then_k2_in_deterministic_mode(cuda):
    q = _randn((1, 6, 300, 64), torch.bfloat16, cuda, 0).requires_grad_()
    k = _randn((1, 2, 300, 64), torch.bfloat16, cuda, 1).requires_grad_()
    v = _randn((1, 2, 300, 64), torch.bfloat16, cuda, 2).requires_grad_()
    do = _randn((1, 6, 300, 64), torch.bfloat16, cuda, 3)
    counts = lambda: (fa.flash_attention.launches,            # noqa: E731
                      fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd_fused.launches,
                      fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkv.launches)
    c0 = counts()
    g3 = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), do)
    c1 = counts()
    assert [b - a for a, b in zip(c0, c1)] == [0, 1, 1, 0, 0]
    torch.use_deterministic_algorithms(True)
    try:
        g2a = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), do)
        g2b = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), do)
    finally:
        torch.use_deterministic_algorithms(False)
    c2 = counts()
    assert [b - a for a, b in zip(c1, c2)] == [0, 2, 0, 2, 2]
    for a, b in zip(g2a, g2b):                 # K2 is bit-reproducible
        assert torch.equal(a, b)
    assert torch.equal(g3[1], g2a[1]) and torch.equal(g3[2], g2a[2])
    pinned = torch.autograd.grad(fa.flash_attention(q, k, v, fused_bwd=False),
                                 (q, k, v), do)   # K2 outside the mode
    c3 = counts()
    assert [b - a for a, b in zip(c2, c3)] == [0, 1, 0, 1, 1]
    assert all(torch.equal(a, b) for a, b in zip(pinned, g2a))
    c2 = c3
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    assert counts()[0] == c2[0] + 1            # serving: K1 without lse


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """A reduced fp32 model with head_dim 64 (the kernels' width) and
    seq 300 > attn_flash_min_seq: one train step on the card (K1 with
    lse, K3) against the CPU's plain versions from the same weights.
    Loss and grad norm: fp32 in another summation order, 1e-5 relative.
    Parameters: one AdamW step moves an entry by about lr·sign(g), so an
    entry whose gradient is within rounding of zero may differ by up to
    2·lr; on average they agree to 1e-4·lr."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.optim.adamw import iter_leaves
    from repro_torch.train.steps import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              head_dim=64, attn_flash_min_seq=256)
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    gpu, cpu = LanguageModel(cfg, device=cuda), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (2, 301))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    states, metrics = [], []
    for model in (gpu, cpu):
        p = _tree_to(params, model.device)      # copies: updated in place
        state = {"params": p, "opt": init_opt_state(p, oc)}
        before = (fa.flash_attention_fwd.launches,
                  fa.flash_attention_bwd_fused.launches)
        state, m = make_train_step(model, oc)(
            state, {k: v.to(model.device) for k, v in batch.items()})
        if model is gpu:
            torch.cuda.synchronize()
            assert (fa.flash_attention_fwd.launches - before[0],
                    fa.flash_attention_bwd_fused.launches - before[1]) == \
                (2 * cfg.num_layers, cfg.num_layers)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    for k in ("loss", "grad_norm"):
        assert metrics[0][k] == pytest.approx(metrics[1][k], rel=1e-5), k
    for (path, a), (_p, b) in zip(iter_leaves(states[0]["params"]),
                                  iter_leaves(states[1]["params"])):
        diff = (a.cpu() - b).abs()
        assert diff.max().item() <= 2 * oc.peak_lr, path
        assert diff.mean().item() <= 1e-4 * oc.peak_lr, path


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}
