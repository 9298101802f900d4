"""Card-only checks: the CUDA kernels K1 (with and without its
logsumexp; K1, K2 and K3 on tensor cores in bf16), K4f, K4b, K5 (split
across blocks, then combined) — at head
widths 32, 64, 120 and 128 — the partition copies K6, K7, K8 and the
SSD scan K9 against their plain PyTorch versions on the same inputs, a
reduced train step (tiled and megakernel routes) and reduced SSM /
hybrid serving on the card against the CPU, the runtime's fused copy
on the card against its numpy backend, and the MoE layer and a reduced
arctic model on the card against the CPU (the layer also twice for the
same bits); K1, K1-lse, K2 and K3 at DeepSeek-V2's MLA widths (q/k 192,
v 128), (48, 32) and its absorbed route's (576, 512) against their
plain versions, a reduced MLA model on the card against the CPU, and
the absorbed route's mla_prefill / mla_train at the full kernel widths
on the card against the CPU; K1, K1-lse, K2, K3 and K5 at
whisper-small's shapes (G 1, hd 64) against their plain versions, and
reduced whisper (encoder-decoder) and llava (patch prefix) models on the
card against the CPU.
They skip (from inside the fixture) where torch sees no CUDA device; on
a machine with the card run

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import partition_copy as pc
from repro_torch.kernels import ssd_scan as ssd

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
    (2, 2, 4, 256, 64, 257, 40, torch.float32),     # past the cache end
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
    q = torch.zeros((1, 2, 8, 100), device=cuda)    # not a multiple of 8
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 584), device=cuda)    # wider than 576
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 136), device=cuda)    # K5: wider than 128
    with pytest.raises(ValueError):
        fd.flash_decode(q[:, :, :1].reshape(1, 2, 1, 136), q, q,
                        torch.ones(1, dtype=torch.int32, device=cuda))
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


# head widths the kernels run at a wider compiled one: h2o-danube3-4b's
# 120 (at 128) with its 4096 window biting on the last 256 rows of 4352,
# and the reduced configs' 32 (at 64)
WIDTH_CASES = [  # b, h, kh, s, hd, dtype, window
    (1, 8, 2, 4352, 120, torch.bfloat16, 4096),
    (1, 8, 2, 4352, 120, torch.float32, 4096),
    (2, 4, 2, 300, 32, torch.bfloat16, 0),
    (2, 4, 2, 300, 32, torch.float32, 64),
]


@pytest.mark.parametrize("b,h,kh,s,hd,dtype,window", WIDTH_CASES)
def test_kernels_at_narrow_head_widths_match_plain(cuda, b, h, kh, s, hd,
                                                   dtype, window):
    """K1, K1-lse, K2, K3 and K5 at a head width narrower than the
    compiled one, against their plain versions (tolerances as above)."""
    q = _randn((b, h, s, hd), dtype, cuda, 10)
    k = _randn((b, kh, s, hd), dtype, cuda, 11)
    v = _randn((b, kh, s, hd), dtype, cuda, 12)
    do = _randn((b, h, s, hd), dtype, cuda, 13)
    kw = dict(causal=True, window=window)
    counts = lambda: (fa.flash_attention.launches,           # noqa: E731
                      fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkv.launches,
                      fa.flash_attention_bwd_fused.launches,
                      fd.flash_decode.launches)
    before = counts()
    with torch.no_grad():
        served = fa.flash_attention(q, k, v, **kw)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True,
                                                  **kw)
    for got in (served, out):
        assert got.shape == q.shape
        assert (got.float() - want_out.float()).abs().max().item() \
            <= TOL[dtype]
    _close(lse, want_lse, (1e-5, 1e-4))
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    dq2 = fa.flash_attention_bwd_dq(*args, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args, **kw)
    dq3, dk3, dv3 = fa.flash_attention_bwd_fused(*args, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for got2, got3, w in zip((dq2, dk2, dv2), (dq3, dk3, dv3), want):
        _close(got2, w, BWD_TOL[dtype])
        _close(got3, w, BWD_TOL[dtype])
    assert torch.equal(dk2, dk3) and torch.equal(dv2, dv3)
    # decode the last position against the whole cache, window counted
    # from cur_len
    qd = q[:, :, -1].reshape(b, kh, h // kh, hd).contiguous()
    cur = torch.full((1,), s, dtype=torch.int32, device=cuda)
    dec = fd.flash_decode(qd, k, v, cur, window=window)
    want_dec = fd.flash_decode_plain(qd, k, v, cur, window=window)
    assert (dec.float() - want_dec.float()).abs().max().item() <= TOL[dtype]
    assert [a - b_ for a, b_ in zip(counts(), before)] == [1, 1, 1, 1, 1, 1]


@pytest.mark.parametrize("hd", [32, 64, 120, 128])
@pytest.mark.parametrize("sq,sk,q_offset,window", [
    (200, 200, 0, 0),        # causal from row 0, ragged against BQ 64
    (333, 461, 128, 0),      # ragged Sq and Sk, q stripe at offset 128
    (333, 461, 128, 100),    # and a window
    (1, 300, 299, 0),        # one query row, at the last position
    (1, 300, 299, 64),
])
def test_tensor_core_forward_matches_plain(cuda, hd, sq, sk, q_offset,
                                           window):
    """The bf16 K1 (tensor cores) at both compiled widths and at 32 and
    120, against its plain version: the output with and without lse (the
    same bits), lse, the same bits twice, and K1-lse's lse through K2 and
    K3 against the plain backward."""
    b, h, kh = 2, 6, 2
    bf = torch.bfloat16
    q = _randn((b, h, sq, hd), bf, cuda, 30)
    k = _randn((b, kh, sk, hd), bf, cuda, 31)
    v = _randn((b, kh, sk, hd), bf, cuda, 32)
    do = _randn((b, h, sq, hd), bf, cuda, 33)
    kw = dict(causal=True, window=window)
    before = fa.flash_attention.launches
    with torch.no_grad():
        served = fa.flash_attention(q, k, v, q_offset, **kw)
    assert fa.flash_attention.launches == before + 1
    out, lse = fa.flash_attention_fwd(q, k, v, q_offset, **kw)
    again = fa.flash_attention_fwd(q, k, v, q_offset, **kw)
    torch.cuda.synchronize()
    assert torch.equal(served, out)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, q_offset,
                                                  with_lse=True, **kw)
    assert (out.float() - want_out.float()).abs().max().item() <= TOL[bf]
    _close(lse, want_lse, (1e-5, 1e-4))
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, q_offset)
    dq2 = fa.flash_attention_bwd_dq(*args, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args, **kw)
    fused = fa.flash_attention_bwd_fused(*args, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, q_offset,
                                        **kw)
    for got2, got3, w in zip((dq2, dk2, dv2), fused, want):
        _close(got2, w, BWD_TOL[bf])
        _close(got3, w, BWD_TOL[bf])
    assert fa.fwd_occupancy(hd, bf) >= 1
    assert fa.fwd_occupancy(hd, torch.float32) >= 1


@pytest.mark.parametrize("hd", [32, 64, 120, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_decode_matches_plain(cuda, hd, dtype):
    """K5's split kernel and combine at every compiled width (and 32,
    120): cur_len 1 (one live row, every other split empty), short spans
    that leave splits empty, the end of S, past S, windows, a window
    wider than S; against the plain version, and the same bits twice."""
    b, kh, g, s = 2, 2, 3, 2048
    q = _randn((b, kh, g, hd), dtype, cuda, 40)
    kc = _randn((b, kh, s, hd), dtype, cuda, 41)
    vc = _randn((b, kh, s, hd), dtype, cuda, 42)
    for cur, window in [(1, 0), (1, 64), (37, 0), (200, 0), (s, 0),
                        (s, 512), (s + 1, 0), (s + 1, 300), (1000, 4096),
                        (1500, 64)]:
        cur_t = torch.full((1,), cur, dtype=torch.int32, device=cuda)
        got = fd.flash_decode(q, kc, vc, cur_t, window=window)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        splits = autotune.decode_splits(b, kh, s, window, sms)
        assert fd.flash_decode.last_splits == splits
        again = fd.flash_decode(q, kc, vc, cur_t, window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (cur, window)
        want = fd.flash_decode_plain(q, kc, vc, cur_t, window=window)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype], (cur, window, splits, err)
    assert autotune.decode_splits(b, kh, s, 0) == 16   # empty splits above


def test_decode_refuses_another_tile(cuda):
    """The host plans K5's splits with ``autotune.DECODE_TILE``; a launch
    that names another tile than the kernel's own is refused, so the two
    chunk rules cannot drift apart unseen."""
    from repro_torch.kernels import _build
    b, kh, g, s, hd = 1, 1, 1, 256, 64
    q = _randn((b, kh, g, hd), torch.bfloat16, cuda, 43)
    kc = _randn((b, kh, s, hd), torch.bfloat16, cuda, 44)
    cur = torch.full((1,), s, dtype=torch.int32, device=cuda)
    out = torch.empty_like(q)
    part = torch.empty(b * kh * 2 * g * (hd + 2), dtype=torch.float32,
                       device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for tile, ok in ((autotune.DECODE_TILE, True),
                     (2 * autotune.DECODE_TILE, False)):
        err = _build.load().repro_flash_decode(
            q.data_ptr(), kc.data_ptr(), kc.data_ptr(), cur.data_ptr(),
            out.data_ptr(), part.data_ptr(), b, kh, g, s, hd, 0, 2, tile, 1,
            1.0 / np.sqrt(hd), stream)
        assert (err == 0) == ok, (tile, err)


@pytest.mark.parametrize("hd", [64, 120, 128])
def test_tensor_core_backward_matches_plain(cuda, hd):
    """The bf16 K2 and K3 (tensor cores) at each compiled width and at
    120, with a ragged Sq against both tile heights, a q stripe at offset
    128 and a window: against the plain backward, K2 twice the same bits,
    K3's dk/dv equal to K2's, K3's dq within one bf16 rounding of K2's."""
    b, h, kh, sq, off, window = 2, 6, 2, 333, 128, 200
    sk = sq + off
    q = _randn((b, h, sq, hd), torch.bfloat16, cuda, 20)
    k = _randn((b, kh, sk, hd), torch.bfloat16, cuda, 21)
    v = _randn((b, kh, sk, hd), torch.bfloat16, cuda, 22)
    do = _randn((b, h, sq, hd), torch.bfloat16, cuda, 23)
    kw = dict(causal=True, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, off, **kw)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, off)
    first = (fa.flash_attention_bwd_dq(*args, **kw),
             *fa.flash_attention_bwd_dkv(*args, **kw))
    second = (fa.flash_attention_bwd_dq(*args, **kw),
              *fa.flash_attention_bwd_dkv(*args, **kw))
    fused = fa.flash_attention_bwd_fused(*args, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, off, **kw)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    for got2, got3, w in zip(first, fused, want):
        _close(got2, w, BWD_TOL[torch.bfloat16])
        _close(got3, w, BWD_TOL[torch.bfloat16])
    assert torch.equal(first[1], fused[1]) and torch.equal(first[2], fused[2])
    _close(fused[0], first[0], (2.0 ** -7, 1e-4))
    for which in ("dq", "dkv", "fused"):
        assert fa.bwd_occupancy(which, hd, torch.bfloat16) >= 1


def test_reduced_config_runs_the_kernels_at_head_dim_32(cuda):
    """The reduced smollm as it is (head_dim 32) with
    ``attn_flash_min_seq=32``, fp32, B 2 x S 96: prefill (K1) and two
    decode steps (K5) and the train loss's gradients (K1-lse, K3) on the
    card against the CPU's plain path.  Logits 1e-4 (fp32, O(1));
    gradients 1e-4 of each leaf's largest entry."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim.adamw import iter_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              attn_flash_min_seq=32)
    assert cfg.head_dim == 32
    gpu, cpu = LanguageModel(cfg, device=cuda), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_gpu = _tree_to(params, cuda)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 97)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    k1, k5 = fa.flash_attention.launches, fd.flash_decode.launches
    with torch.no_grad():
        lg, cg = gpu.prefill(params_gpu, {"tokens": batch["tokens"].to(cuda)})
        lc, cc = cpu.prefill(params, {"tokens": batch["tokens"]})
        assert (lg.cpu() - lc).abs().max().item() <= 1e-4
        cg = gpu.alloc_cache(2, 98, init=cg)
        cc = cpu.alloc_cache(2, 98, init=cc)
        for i in range(2):
            tok = toks[:, i:i + 1]
            lg, cg = gpu.decode_step(params_gpu, cg, tok.to(cuda), 96 + i)
            lc, cc = cpu.decode_step(params, cc, tok, 96 + i)
            assert (lg.cpu() - lc).abs().max().item() <= 1e-4
    assert fa.flash_attention.launches - k1 == cfg.num_layers
    assert fd.flash_decode.launches - k5 == 2 * cfg.num_layers

    def grads(model, p, dev):
        leaves = [x.requires_grad_() for _p, x in iter_leaves(p)]
        loss, _ = model.train_loss(p, {k: v.to(dev) for k, v in batch.items()})
        return loss.item(), torch.autograd.grad(loss, leaves)

    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_fused.launches)
    loss_g, g_gpu = grads(gpu, params_gpu, cuda)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches - before[0],
            fa.flash_attention_bwd_fused.launches - before[1]) == \
        (2 * cfg.num_layers, cfg.num_layers)
    loss_c, g_cpu = grads(cpu, params, "cpu")
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, c in zip(g_gpu, g_cpu):
        assert (a.cpu() - c).abs().max().item() \
            <= 1e-4 * c.abs().max().item()


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


# ------------------------------------------------ partition copies (K6-K8)

def _bytes(rows, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (rows, pc.LANES),
                                         dtype=np.uint8)).to(device)


@pytest.mark.parametrize("nd,ns,d0,s0,rows", [
    (1024, 1024, 256, 512, 256),      # one tile
    (2048, 2048, 0, 1024, 512),       # two tiles
    (512, 1536, 256, 0, 256),
    (300, 300, 100, 200, 100),        # a range shorter than a tile
])
def test_partition_copy_kernel_matches_plain(cuda, nd, ns, d0, s0, rows):
    dst, src = _bytes(nd, 0, cuda), _bytes(ns, 1, cuda)
    want = pc.partition_copy_plain(dst.clone(), src, d0, s0, rows)
    before = pc.partition_copy.launches
    got = pc.partition_copy(dst, src, d0, s0, rows)
    torch.cuda.synchronize()
    assert pc.partition_copy.launches == before + 1
    assert torch.equal(got, want)


# (dst_row, src_row, rows): ragged edges, adjacent destinations, two
# ranges gathering the same source rows, both buffers' tails
HAZARD = ((0, 1000, 512), (1024, 1000, 512), (1536, 256, 512),
          (2049, 256, 511), (4095 - 129, 4095 - 129, 129))


@pytest.mark.parametrize("ranges", [
    ((0, 1, 3),),
    ((1, 0, 2), (8, 16, 1), (32, 4, 5)),
    ((0, 0, 300), (700, 350, 257)),
    tuple((i * 8, ((i + 7) % 64) * 8, 7) for i in range(64)),
    HAZARD,
])
def test_multi_partition_copy_tiles_matches_plain(cuda, ranges):
    dst, src = _bytes(4095, 2, cuda), _bytes(4095, 3, cuda)
    want = pc.multi_partition_copy_plain(dst.clone(), src, ranges)
    before = pc.multi_partition_copy_tiles.launches
    got = pc.multi_partition_copy_tiles(dst, src, ranges)
    torch.cuda.synchronize()
    assert pc.multi_partition_copy_tiles.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", [16, 64, 512])
@pytest.mark.parametrize("ranges", [
    HAZARD,
    tuple((i * 60, ((i + 7) % 64) * 60, 59 - i % 3) for i in range(64)),
])
def test_multi_partition_copy_staged_matches_plain(cuda, chunk, ranges):
    dst, src = _bytes(4095, 4, cuda), _bytes(4095, 5, cuda)
    want = pc.multi_partition_copy_plain(dst.clone(), src, ranges)
    before = pc.multi_partition_copy_staged.launches
    got = pc.multi_partition_copy_staged(dst, src, ranges, chunk=chunk)
    torch.cuda.synchronize()
    assert pc.multi_partition_copy_staged.launches == before + 1
    assert torch.equal(got, want)


# past MAX_PARAM_RANGES, with empty and one-row ranges among them
MANY = tuple((i * 13, (i * 7) % 300 * 13, (13 - i % 3) * (i % 17 != 5))
             for i in range(300)) + ((3900, 4000, 1), (3901, 0, 0))


SMALL_SETS = (
    HAZARD,
    tuple((i * 60, ((i + 7) % 64) * 60, 59 - i % 3) for i in range(64)),
    ((5, 9, 0), (0, 3, 1), (9, 9, 0), (1, 700, 300), (400, 0, 1)),
)


@pytest.mark.parametrize("ranges,route", [
    *((r, route) for r in SMALL_SETS for route in ("param", "device")),
    (MANY, "device"),
])
@pytest.mark.parametrize("kernel", ["tiles", "staged"])
def test_copy_descriptor_routes_match_plain(cuda, kernel, ranges, route):
    """K7 and K8 on both routes of their range descriptor (a set past
    MAX_PARAM_RANGES only on the card), one launch each, bit for bit."""
    dst, src = _bytes(4095, 10, cuda), _bytes(4095, 11, cuda)
    want = pc.multi_partition_copy_plain(dst.clone(), src, ranges)
    wrapper = getattr(pc, f"multi_partition_copy_{kernel}")
    launch, rows = ((pc.launch_tiles, pc.BLOCK_ROWS) if kernel == "tiles"
                    else (pc.launch_staged, 64))
    desc = pc.descriptor(ranges, rows, cuda, route=route)
    before = wrapper.launches
    got = launch(dst, src, desc)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.last_route) == (before + 1, route)
    assert torch.equal(got, want)
    if pc.descriptor_route(len(ranges)) == route:   # the wrapper's own route
        got = wrapper(_bytes(4095, 10, cuda), src, ranges)
        torch.cuda.synchronize()
        assert (wrapper.launches, wrapper.last_route) == (before + 2, route)
        assert torch.equal(got, want)


def test_param_descriptor_past_the_cap_is_refused(cuda):
    dst, src = _bytes(4095, 12, cuda), _bytes(4095, 13, cuda)
    desc = pc.descriptor(MANY, pc.BLOCK_ROWS, cuda, route="param")
    with pytest.raises(RuntimeError, match="CUDA error"):
        pc.launch_tiles(dst, src, desc)


def test_multi_partition_copy_routes_past_the_threshold(cuda):
    rows = pc.DMA_STAGE_BYTES // pc.LANES
    ranges = ((0, 128, 3000), (50_000, 0, 7000), (rows - 4000, 60_000, 3999))
    counts = lambda: (pc.multi_partition_copy_tiles.launches,  # noqa: E731
                      pc.multi_partition_copy_staged.launches)
    for extra, want_counts in ((0, (1, 0)), (1, (0, 1))):
        dst, src = _bytes(rows + extra, 6, cuda), _bytes(rows, 7, cuda)
        want = pc.multi_partition_copy_plain(dst.clone(), src, ranges)
        before = counts()
        got = pc.multi_partition_copy(dst, src, ranges)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(before, counts())) == want_counts
        assert torch.equal(got, want)


def test_copy_wrappers_reject_what_the_kernels_do_not_take(cuda):
    dst, src = _bytes(64, 8, cuda), _bytes(64, 9, cuda)
    with pytest.raises(ValueError, match="overlap"):
        pc.multi_partition_copy_tiles(dst, src, ((0, 0, 8), (4, 16, 8)))
    with pytest.raises(ValueError, match="out of bounds"):
        pc.multi_partition_copy_staged(dst, src, ((60, 0, 8),))
    with pytest.raises(ValueError, match="shares memory"):
        pc.multi_partition_copy_tiles(dst[:32], dst[16:48], ((0, 0, 8),))
    with pytest.raises(TypeError):
        pc.multi_partition_copy_tiles(dst.float(), src.float(), ((0, 0, 8),))
    with pytest.raises(ValueError, match="multiples"):
        pc.partition_copy(dst, src, 3, 0, 8)
    with pytest.raises(ValueError, match="aligned"):
        flat = dst.reshape(-1)
        pc.multi_partition_copy_tiles(flat[1:1 + 32 * 128].view(-1, 128),
                                      src, ((0, 0, 8),))
    with pytest.raises(ValueError):
        pc.multi_partition_copy_tiles(dst, src.cpu(), ((0, 0, 8),))


def test_runtime_fused_copy_on_the_card_matches_numpy(cuda):
    from repro_torch.core import NULL_GUID, Runtime, spawn_main

    def run(**kw):
        rt = Runtime(**kw)
        out = {}
        size, psize = 64 * 1024, 1024

        def main(paramv, depv, api):
            block, ptr = api.db_create(size)
            ptr[:] = np.frombuffer(np.random.default_rng(7).bytes(size),
                                   np.uint8)
            api.db_release(block)
            shadow, _ = api.db_create(size)
            api.db_release(shadow)
            for i in range(64):
                api.db_copy(shadow, i * psize + 128 * (i % 3),
                            block, ((i + 7) % 64) * psize, psize - 256)
            out["shadow"] = shadow
            return NULL_GUID

        spawn_main(rt, main)
        stats = rt.run()
        return rt.lookup(out["shadow"]).buffer.copy(), stats

    before = pc.multi_partition_copy_tiles.launches
    got, stats = run(copy_backend="cuda")
    assert pc.multi_partition_copy_tiles.launches == before + 1
    want, ref = run(copy_backend="numpy")
    assert np.array_equal(got, want)
    assert (stats.fused_copies, ref.fused_copies) == (1, 0)
    assert stats.bytes_copied == ref.bytes_copied


# ------------------------------------------------------- SSD scan (K9)

def _ssd_inputs(b, h, s, p, n, dtype, device, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, s, p).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.randn(b, h, s))).astype(
        np.float32))
    A = torch.from_numpy((-np.exp(rng.randn(h) * 0.5)).astype(np.float32))
    B = torch.from_numpy(rng.randn(b, s, n).astype(np.float32))
    C = torch.from_numpy(rng.randn(b, s, n).astype(np.float32))
    return (x.to(device, dtype), dt.to(device), A.to(device),
            B.to(device, dtype), C.to(device, dtype))


@pytest.mark.parametrize("b,h,s,p,n,chunk,dtype", [
    (1, 2, 64, 16, 8, 16, torch.float32),
    (2, 4, 128, 32, 16, 32, torch.float32),
    (2, 8, 64, 8, 64, 64, torch.float32),
    (1, 3, 65, 32, 16, 16, torch.float32),       # ragged, reduced shape
    (2, 3, 30, 8, 8, 10, torch.float32),         # chunk not a multiple of 16
    (1, 4, 300, 64, 128, 128, torch.bfloat16),   # mamba2's P, N; ragged
    (2, 4, 256, 64, 64, 128, torch.bfloat16),    # zamba2's N
    # prompts shorter than the chunk, Q = S not a whole number of strips
    (1, 4, 40, 64, 128, 128, torch.bfloat16),
    (1, 4, 70, 64, 128, 128, torch.bfloat16),
    (1, 4, 100, 64, 128, 128, torch.bfloat16),
    (2, 3, 100, 32, 16, 40, torch.float32),      # chunk 40, ragged
])
def test_ssd_scan_kernel_matches_plain(cuda, b, h, s, p, n, chunk, dtype):
    """y: fp32 in another summation order (1e-4 of max|y|), bf16 one
    rounding of y apart (2^-7 relative); state fp32, 1e-4 of max|state|
    (the decays exp(total - cum) carry the cumsum's rounding)."""
    args = _ssd_inputs(b, h, s, p, n, dtype, cuda, s + n)
    before = ssd.ssd_scan.launches
    y, st = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    yw, sw = ssd.ssd_scan_plain(*args, chunk=chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    d = (y.float() - yw.float()).abs()
    top = yw.float().abs()
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    assert (d <= rel * top + 1e-4 * top.max()).all()
    assert (st - sw).abs().max().item() <= 1e-4 * sw.abs().max().item()


def test_ssd_scan_reads_the_model_layout_through_strides(cuda):
    from repro_torch.kernels import ops
    x, dt, A, B, C = _ssd_inputs(2, 8, 200, 64, 128, torch.bfloat16, cuda, 5)
    y1, s1 = ops.ssd_scan(x.transpose(1, 2).contiguous(),
                          dt.transpose(1, 2).contiguous(), A, B, C)
    y2, s2 = ssd.ssd_scan(x, dt, A, B, C)
    assert y1.is_contiguous()
    assert torch.equal(y1.transpose(1, 2), y2) and torch.equal(s1, s2)


def test_ssd_scan_rejects_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 2, 64, 16, 8, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="P="):
        ssd.ssd_scan(x[..., :12], dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan(x, dt, A, B, C, chunk=0)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.bfloat16(), dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd.ssd_scan(x, dt.cpu(), A, B, C, chunk=16)
    xb, dtb, Ab, Bb, Cb = _ssd_inputs(1, 2, 256, 16, 8, torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="chunk 256"):
        ssd.ssd_scan(xb, dtb, Ab, Bb, Cb, chunk=256)


def _bwd_close(got, want):
    """K9b against the plain backward: bf16 outputs one rounding apart
    (2^-7 relative) plus 1e-4 of the largest |value|; fp32 1e-4 of it
    (summation order); dA, a sum of B·S products that cancel, 1e-3."""
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        d = (g.float() - w.float()).abs()
        top = w.float().abs()
        scale = max(top.max().item(), 1e-30)
        if name == "dA":
            assert d.max().item() <= 1e-3 * scale, name
            continue
        rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        assert (d <= rel * top + 1e-4 * scale).all(), name


SSD_BWD_CASES = [  # b, h, s, p, n, chunk, dtype, dstate
    (2, 8, 65, 32, 16, 16, torch.float32, False),     # reduced, ragged
    (2, 3, 30, 8, 8, 10, torch.float32, True),        # chunk not 16k
    (1, 3, 100, 64, 128, 128, torch.float32, True),   # full width fp32
    (2, 4, 256, 64, 64, 128, torch.bfloat16, False),  # zamba2's N
    (1, 4, 300, 64, 128, 128, torch.bfloat16, True),  # mamba2's, ragged
    (1, 4, 70, 64, 128, 128, torch.bfloat16, False),  # one short chunk
    (1, 9, 200, 64, 128, 128, torch.bfloat16, False),  # two head groups
    # the tc route at narrow shapes: K9bc's 16-column tiles, P of 16, 32
    (2, 8, 65, 32, 16, 16, torch.bfloat16, True),
    (1, 3, 50, 16, 48, 32, torch.bfloat16, False),
    (1, 3, 40, 8, 24, 16, torch.bfloat16, True),     # bf16 off the tc route
]


@pytest.mark.parametrize("b,h,s,p,n,chunk,dtype,with_ds", SSD_BWD_CASES)
def test_ssd_scan_backward_kernel_matches_plain(cuda, b, h, s, p, n, chunk,
                                                dtype, with_ds):
    """K9b (one counted call) against ssd_scan_bwd_plain, and the same
    bits from a second call."""
    args = _ssd_inputs(b, h, s, p, n, dtype, cuda, s + n + 1)
    rng = np.random.RandomState(s)
    dy = torch.from_numpy(rng.randn(b, h, s, p).astype(np.float32)).to(
        cuda, dtype)
    ds = (torch.from_numpy(rng.randn(b, h, p, n).astype(np.float32)).to(cuda)
          if with_ds else None)
    before = ssd.ssd_scan.bwd_launches
    got = ssd._launch_bwd(*args, dy, ds, chunk)
    again = ssd._launch_bwd(*args, dy, ds, chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.bwd_launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _bwd_close(got, ssd.ssd_scan_bwd_plain(*args, dy, ds, chunk=chunk))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_backward_launches_k9b_on_the_card(cuda, dtype,
                                                    monkeypatch):
    """Autograd through ops.ssd_scan on the model layout: one K9b call,
    never the plain backward, dy arriving as a strided view; the
    gradients (model layout) are the plain backward's."""
    from repro_torch.kernels import ops
    b, h, s, p, n = 2, 4, 200, 64, 64
    x, dt, A, B, C = _ssd_inputs(b, h, s, p, n, dtype, cuda, 9)
    leaves = [x.transpose(1, 2).contiguous().requires_grad_(),
              dt.transpose(1, 2).contiguous().requires_grad_(),
              A.clone().requires_grad_(), B.clone().requires_grad_(),
              C.clone().requires_grad_()]
    dy = torch.randn((b, s, h, p), device=cuda).to(dtype)
    plain = ssd.ssd_scan_bwd_plain
    monkeypatch.setattr(ssd, "ssd_scan_bwd_plain", None)   # never called
    before = ssd.ssd_scan.bwd_launches
    y, _ = ops.ssd_scan(*leaves, chunk=128)
    grads = torch.autograd.grad((y.float() * dy.float()).sum(), leaves)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.bwd_launches == before + 1
    want = plain(x, dt, A, B, C, dy.transpose(1, 2), chunk=128)
    got = (grads[0].transpose(1, 2), grads[1].transpose(1, 2), *grads[2:])
    _bwd_close(got, want)


def test_ssd_scan_backward_scratch_is_freed(cuda):
    """K9b's workspace and K9s's scratch live for the call only."""
    args = _ssd_inputs(2, 8, 1024, 64, 128, torch.bfloat16, cuda, 8)
    dy = torch.randn((2, 8, 1024, 64), device=cuda).to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    grads = ssd._launch_bwd(*args, dy, None, 128)
    torch.cuda.synchronize()
    kept = sum(g.numel() * g.element_size() for g in grads)
    del grads
    assert torch.cuda.memory_allocated() == base and kept > 0


# the bf16 cases of test_ssd_scan_kernel_matches_plain, and batch 1 x 2048
# with mamba2's 64 heads: all on the tc route
SSD_TC_CASES = [  # b, h, s, p, n, chunk
    (1, 4, 300, 64, 128, 128),
    (2, 4, 256, 64, 64, 128),
    (1, 4, 40, 64, 128, 128),
    (1, 4, 70, 64, 128, 128),
    (1, 4, 100, 64, 128, 128),
    (1, 64, 2048, 64, 128, 128),
]


@pytest.mark.parametrize("b,h,s,p,n,chunk", SSD_TC_CASES)
def test_ssd_scan_tc_route_matches_the_staged_plain_versions(
        cuda, b, h, s, p, n, chunk):
    """One counted launch on the tc route; y one bf16 rounding from the
    staged plain versions (2^-7 relative, 1e-4 of max|y| near zero), the
    final and the entering states 1e-4 of their largest |value| (the
    entering ones read back as their hi + lo pair); the two stages run
    alone give the same bits."""
    args = _ssd_inputs(b, h, s, p, n, torch.bfloat16, cuda, s + n)
    before = ssd.ssd_scan.launches
    y, st = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    assert ssd.ssd_scan.last_route == "tc"
    entering, final = ssd.ssd_chunk_states_plain(*args[:4], chunk=chunk)
    yw = ssd.ssd_chunk_scan_plain(*args, entering, chunk=chunk)
    d = (y.float() - yw.float()).abs()
    top = yw.float().abs()
    assert (d <= 2.0 ** -7 * top + 1e-4 * top.max()).all()
    assert (st - final).abs().max().item() <= 1e-4 * final.abs().max().item()
    scratch, st2 = ssd.chunk_states_tc(*args, chunk=chunk)
    got = ssd.states_from_scratch(scratch)
    assert got.shape == entering.shape
    assert (got - entering).abs().max().item() <= \
        1e-4 * max(entering.abs().max().item(), 1e-30)
    y2 = ssd.chunk_scan_tc(*args, scratch, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y2, y) and torch.equal(st2, st)
    assert ssd.ssd_scan.launches == before + 1    # the stages count nothing


def test_ssd_scan_route_follows_dtype_and_shape(cuda):
    for dtype, p, n, want in ((torch.bfloat16, 64, 128, "tc"),
                              (torch.float32, 64, 128, "fp32"),
                              (torch.bfloat16, 32, 8, "fp32")):
        args = _ssd_inputs(1, 2, 64, p, n, dtype, cuda, p + n)
        before = ssd.ssd_scan.launches
        ssd.ssd_scan(*args, chunk=32)
        assert ssd.ssd_scan.launches == before + 1
        assert ssd.ssd_scan.last_route == want == ssd.route(dtype, p, n, 32)


def test_ssd_scan_tc_scratch_is_freed(cuda):
    """The entering states' scratch (B·H·nc·P·N·4 bytes) lives for the
    call only: the peak holds it, and nothing but y and the state stays."""
    b, h, s, p, n = 2, 8, 1024, 64, 128
    args = _ssd_inputs(b, h, s, p, n, torch.bfloat16, cuda, 7)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, st = ssd.ssd_scan(*args)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.last_route == "tc"
    scratch = b * h * (s // 128) * p * n * 4
    assert torch.cuda.max_memory_allocated() - base >= scratch
    del y, st
    assert torch.cuda.memory_allocated() == base


def test_ssd_scan_tc_reads_the_model_layout_through_strides(cuda):
    from repro_torch.kernels import ops
    x, dt, A, B, C = _ssd_inputs(2, 8, 300, 64, 64, torch.bfloat16, cuda, 6)
    y1, s1 = ops.ssd_scan(x.transpose(1, 2).contiguous(),
                          dt.transpose(1, 2).contiguous(), A, B, C)
    assert ssd.ssd_scan.last_route == "tc"
    y2, s2 = ssd.ssd_scan(x, dt, A, B, C)
    assert y1.is_contiguous()
    assert torch.equal(y1.transpose(1, 2), y2) and torch.equal(s1, s2)


def test_partition_copy_at_128_mib_writes_only_its_range(cuda):
    """K6 at chip_smoke's timed shape: one 128 MiB range of 256 MiB
    buffers, bit-exact, every row outside the range left as it was."""
    rows = 2 ** 20
    dst, src = _bytes(2 * rows, 10, cuda), _bytes(2 * rows, 11, cuda)
    want = pc.partition_copy_plain(dst.clone(), src, rows // 4, rows // 2,
                                   rows)
    pc.partition_copy(dst, src, rows // 4, rows // 2, rows)
    torch.cuda.synchronize()
    assert torch.equal(dst, want)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_ssm_serving_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced fp32 mamba2 / zamba2 (head_dim 64, K5's width): prefill
    (K9 on every Mamba layer) and three decode steps on the card against
    the CPU's plain path from the same weights; logits 1e-3 (fp32, O(1))."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64)
    gpu, cpu = LanguageModel(cfg, device=cuda), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_gpu = _tree_to(params, cuda)
    rng = np.random.RandomState(0)
    s = 45
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, s)))
    before = ssd.ssd_scan.launches
    lg, cg = gpu.prefill(params_gpu, {"tokens": tokens.to(cuda)})
    assert ssd.ssd_scan.launches == before + cfg.num_layers
    lc, cc = cpu.prefill(params, {"tokens": tokens})
    assert (lg.cpu() - lc).abs().max().item() <= 1e-3
    cg, cc = gpu.alloc_cache(2, s + 3, init=cg), cpu.alloc_cache(2, s + 3,
                                                                  init=cc)
    for i in range(3):
        tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 1)))
        lg, cg = gpu.decode_step(params_gpu, cg, tok.to(cuda), s + i)
        lc, cc = cpu.decode_step(params, cc, tok, s + i)
        assert (lg.cpu() - lc).abs().max().item() <= 1e-3


# ------------------------------------- whole-sequence attention (K4f, K4b)

MEGA_CASES = [  # b, h, kh, sq, sk, hd, dtype, window, q_offset
    (64, 15, 5, 256, 256, 64, torch.bfloat16, 0, 0),    # the training shape
    (8, 15, 5, 200, 200, 64, torch.bfloat16, 0, 0),     # ragged
    (8, 15, 5, 100, 100, 64, torch.bfloat16, 0, 0),
    (8, 15, 5, 256, 256, 64, torch.bfloat16, 64, 0),    # window
    (8, 15, 5, 256, 384, 64, torch.bfloat16, 0, 128),   # q stripe
    (8, 15, 5, 192, 256, 64, torch.bfloat16, 0, 64),    # q stripe, ragged
    (8, 5, 5, 256, 256, 64, torch.bfloat16, 0, 0),      # G = 1
    (8, 8, 2, 128, 128, 128, torch.bfloat16, 0, 0),     # hd 128
    (8, 15, 5, 128, 128, 64, torch.float32, 0, 0),      # fp32
    (8, 32, 8, 256, 256, 120, torch.bfloat16, 0, 0),    # hd 120 at width 128
    (64, 15, 5, 256, 384, 64, torch.bfloat16, 96, 128),  # window + stripe
]


def _mega_inputs(cuda, b, h, kh, sq, sk, hd, dtype, seed=0):
    return (_randn((b, h, sq, hd), dtype, cuda, seed),
            _randn((b, kh, sk, hd), dtype, cuda, seed + 1),
            _randn((b, kh, sk, hd), dtype, cuda, seed + 2),
            _randn((b, h, sq, hd), dtype, cuda, seed + 3))


@pytest.mark.parametrize("b,h,kh,sq,sk,hd,dtype,window,q_offset",
                         MEGA_CASES)
def test_mega_kernels_match_plain(cuda, b, h, kh, sq, sk, hd, dtype, window,
                                  q_offset):
    q, k, v, do = _mega_inputs(cuda, b, h, kh, sq, sk, hd, dtype)
    kw = dict(causal=True, window=window)
    before = (fa.flash_attention_mega_fwd.launches,
              fa.flash_attention_mega_fwd.lse_launches,
              fa.flash_attention_mega_bwd.launches)
    out = fa.flash_attention_mega_fwd(q, k, v, q_offset, **kw)
    out_l, lse = fa.flash_attention_mega_fwd(q, k, v, q_offset,
                                             with_lse=True, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, q_offset,
                                                  with_lse=True, **kw)
    for got in (out, out_l):
        assert (got.float() - want_out.float()).abs().max().item() \
            <= TOL[dtype]
    _close(lse, want_lse, (1e-5, 1e-4))
    takes_bwd = autotune.mega_rows(True, sk, hd, q.element_size()) > 0
    if takes_bwd:
        delta = (do.float() * out_l.float()).sum(-1)
        got = fa.flash_attention_mega_bwd(q, k, v, do, lse, delta, q_offset,
                                          **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, out_l, lse, do,
                                            q_offset, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            _close(g, w, BWD_TOL[dtype])
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fa.flash_attention_mega_bwd(q, k, v, do, lse, lse, q_offset,
                                        **kw)
    assert (fa.flash_attention_mega_fwd.launches - before[0],
            fa.flash_attention_mega_fwd.lse_launches - before[1],
            fa.flash_attention_mega_bwd.launches - before[2]) == \
        (2, 1, int(takes_bwd))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mega_backward_is_deterministic_and_matches_k2(cuda, dtype):
    """Two K4b runs give the same bits (no atomics); its dq, dk and dv
    agree with K2's.  In bf16 they are the same bits: the tensor-core K4b
    runs K2's tiles and sums each element in K2's order, skipping only
    chunks that add exact zeros there.  In fp32 the CUDA-core K4b sums in
    another order: fp32 rounding (1e-5 relative)."""
    b, s = (64, 256) if dtype == torch.bfloat16 else (32, 128)
    q, k, v, do = _mega_inputs(cuda, b, 15, 5, s, s, 64, dtype, seed=10)
    out, lse = fa.flash_attention_mega_fwd(q, k, v, with_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    first = fa.flash_attention_mega_bwd(*args)
    second = fa.flash_attention_mega_bwd(*args)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args)
    dq2 = fa.flash_attention_bwd_dq(*args)
    tol = (2.0 ** -7, 1e-4) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    for got, want in zip(first, (dq2, dk2, dv2)):
        _close(got, want, tol)
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)


def test_mixed_plan_feeds_k4f_lse_to_k3(cuda, monkeypatch):
    """K4f's forward with K3's backward (the plan's two gates apart): K3
    reads K4f's lse, and the gradients match the plain backward."""
    q, k, v, do = _mega_inputs(cuda, 64, 15, 5, 256, 256, 64,
                               torch.bfloat16, seed=20)
    monkeypatch.setattr(fa, "attention_plan", lambda *a, **kw: (
        autotune.AttnPlan(mega_fwd=True)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.flash_attention_mega_fwd.lse_launches,
              fa.flash_attention_bwd_fused.launches,
              fa.flash_attention_mega_bwd.launches)
    out = fa.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_mega_fwd.lse_launches - before[0],
            fa.flash_attention_bwd_fused.launches - before[1],
            fa.flash_attention_mega_bwd.launches - before[2]) == (1, 1, 0)
    _out, lse = fa.flash_attention_plain(q, k, v, with_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out.detach(), lse, do)
    for g, w in zip(grads, want):
        _close(g, w, BWD_TOL[torch.bfloat16])


def _longest_sk(bwd, hd, itemsize):
    sk = 1
    while autotune.mega_rows(bwd, sk + 1, hd, itemsize):
        sk += 1
    return sk


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mega_runs_at_the_planners_longest_sk(cuda, hd, dtype):
    """At the longest Sk the planner gives each kernel, the launch's
    shared memory (the planner's sum) holds the block's layout — a block
    traps otherwise — and the results match the plain versions; the
    occupancy calculator finds room for at least one block an SM."""
    for bwd in (False, True):
        sk = _longest_sk(bwd, hd, dtype.itemsize)
        q, k, v, do = _mega_inputs(cuda, 2, 4, 2, sk, sk, hd, dtype, 30)
        out, lse = fa.flash_attention_mega_fwd(q, k, v, with_lse=True)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True)
        assert (out.float() - want_out.float()).abs().max().item() \
            <= TOL[dtype]
        _close(lse, want_lse, (1e-5, 1e-4))
        if bwd:
            delta = (do.float() * out.float()).sum(-1)
            got = fa.flash_attention_mega_bwd(q, k, v, do, lse, delta)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
            for g, w in zip(got, want):
                _close(g, w, BWD_TOL[dtype])
        rows, smem, per_sm = fa.mega_occupancy(bwd, sk, hd, dtype)
        assert rows == autotune.mega_rows(bwd, sk, hd, dtype.itemsize)
        assert smem <= autotune.SMEM_OPTIN_BYTES and per_sm >= 1


def test_mega_backward_without_query_rows_gives_zero_dk_dv(cuda):
    """Sq = 0 launches no block; dk and dv are the zero gradient."""
    q, k, v, do = _mega_inputs(cuda, 2, 4, 2, 0, 16, 64, torch.bfloat16)
    lse = torch.zeros((2, 4, 0), device=cuda)
    dq, dk, dv = fa.flash_attention_mega_bwd(q, k, v, do, lse, lse)
    assert dq.shape == q.shape
    assert not dk.any() and not dv.any()


def test_mega_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 3, 16, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 2049, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        fa.flash_attention_mega_fwd(q, k, k)
    for hd in (32, 120):              # K4 takes only 64 and 128
        q = torch.zeros((1, 2, 8, hd), device=cuda)
        with pytest.raises(ValueError, match="K4 takes"):
            fa.flash_attention_mega_fwd(q, q, q)
        with pytest.raises(ValueError, match="K4 takes"):
            lse = q[..., 0].contiguous()
            fa.flash_attention_mega_bwd(q, q, q, q, lse, lse)


def test_megakernel_train_steps_on_the_card_match_the_cpu(cuda, monkeypatch):
    """The reduced fp32 smollm with head_dim 64, ``attn_flash_min_seq=32``,
    B 72 x S 96 (B·KH = 144 blocks), with the card's measured table
    saying K4 wins at that shape: two train steps on the card, whose
    attention is K4f with lse (twice a layer under remat="layer") and K4b
    (once a layer) and no K1/K2/K3, against the CPU's plain path from the
    same weights.  Loss and grad norm 1e-5 relative (fp32, summation
    order)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              head_dim=64, attn_flash_min_seq=32)
    monkeypatch.setattr(autotune, "MEGA_TIMINGS", (autotune.MegaTiming(
        96, 64, 32, 72, cfg.num_kv_heads, 0.1, 1.0, 0.1, 1.0, "test"),))
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    gpu, cpu = LanguageModel(cfg, device=cuda), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (2, 72, 97))
    counters = (fa.flash_attention, fa.flash_attention_fwd,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_fused, fa.flash_attention_mega_bwd)
    metrics = []
    for model in (gpu, cpu):
        p = _tree_to(params, model.device)
        state = {"params": p, "opt": init_opt_state(p, oc)}
        step = make_train_step(model, oc)
        before = [c.launches for c in counters]
        lse_before = fa.flash_attention_mega_fwd.lse_launches
        ms = []
        for t in toks:
            batch = {"tokens": torch.from_numpy(t[:, :-1]),
                     "targets": torch.from_numpy(t[:, 1:])}
            state, m = step(state, {k: v.to(model.device)
                                    for k, v in batch.items()})
            ms.append({k: float(v) for k, v in m.items()})
        if model is gpu:
            torch.cuda.synchronize()
            got = [c.launches - b for c, b in zip(counters, before)]
            assert got == [0, 0, 0, 0, 0, 2 * cfg.num_layers]
            assert fa.flash_attention_mega_fwd.lse_launches - lse_before \
                == 2 * 2 * cfg.num_layers
        metrics.append(ms)
    for mg, mc in zip(*metrics):
        for k in ("loss", "grad_norm"):
            assert mg[k] == pytest.approx(mc[k], rel=1e-5), k


# ------------------------------------------------------------------ MoE layer

def _moe_cfg(**over):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("arctic-480b").reduced(), **over)


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, cf):
    """Reduced fp32 arctic MoE layer (dense residual) on 2 x 300 tokens,
    with and without drops: the routing (the same experts for every
    token at this seed: a flip fails), the output, every aux entry and
    the gradients on the card against the CPU; 1e-4 of each tensor's
    largest entry (fp32, summation order)."""
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg(capacity_factor=cf)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 300, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    runs = []
    for dev in ("cpu", cuda):
        p = {k: ({n: t.to(dev).requires_grad_() for n, t in v.items()}
                 if isinstance(v, dict) else v.to(dev).requires_grad_())
             for k, v in params.items()}
        xx = x.to(dev).requires_grad_()
        logits = xx.detach().reshape(-1, cfg.d_model) @ p["router"].detach()
        idx = moe._route(logits, cfg.experts_per_token)[1]
        y, aux = moe.moe_ffn(p, xx, cfg)
        leaves = [xx] + [t for v in p.values() for t in
                         (v.values() if isinstance(v, dict) else [v])]
        grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux["loss"],
                                    leaves)
        runs.append((idx.cpu(), y.cpu(),
                     {k: float(v.detach()) for k, v in aux.items()},
                     [g.cpu() for g in grads]))
    (ic, yc, ac, gc), (ig, yg, ag, gg) = runs
    flips = (ic != ig).any(-1).nonzero().flatten().tolist()
    assert not flips, f"tokens {flips} routed to other experts on the card"
    if cf == 1.0:
        assert ac["dropped"] > 0
    assert ac.keys() == ag.keys()
    for k in ac:
        assert ag[k] == pytest.approx(ac[k], rel=1e-5, abs=1e-6), k
    for got, want in [(yg, yc)] + list(zip(gg, gc)):
        assert (got - want).abs().max().item() <= \
            1e-4 * max(want.abs().max().item(), 1e-30)


def test_moe_layer_gives_the_same_bits_twice_on_the_card(cuda):
    """bf16 MoE layer with drops, forward and backward, twice: the same
    bits without the global deterministic switch (dispatch and combine
    write unique slots and gather; no atomics)."""
    from repro_torch.models import moe

    cfg = _moe_cfg(capacity_factor=1.0, dtype="bfloat16",
                   param_dtype="bfloat16", num_experts=8, d_model=512,
                   moe_d_ff=256, d_ff=512)
    params = moe.moe_init(torch.Generator(device=cuda).manual_seed(0), cfg)
    leaves = [t.requires_grad_() for v in params.values() for t in
              (v.values() if isinstance(v, dict) else [v])]
    x = torch.randn(4, 1024, cfg.d_model, device=cuda, dtype=torch.bfloat16,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    x.requires_grad_()
    outs = []
    for _ in range(2):
        y, aux = moe.moe_ffn(params, x, cfg)
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux["loss"],
                                    [x] + leaves)
        outs.append([y, aux["dropped"], aux["loss"], *grads])
    assert float(outs[0][1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_moe_model_on_the_card_matches_the_cpu(cuda):
    """Reduced fp32 arctic (head_dim 64, ``attn_flash_min_seq=32``): prefill
    of 2 x 96 through K1, three decode steps through K5, and one
    ``train_loss`` with its gradients through K1-lse and K3, on the card
    against the CPU's plain path from the same weights; logits 1e-3,
    loss 1e-5 relative, gradients 1e-4 of each leaf's largest entry."""
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim.adamw import iter_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg(head_dim=64, attn_flash_min_seq=32)
    gpu, cpu = LanguageModel(cfg, device=cuda), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_gpu = _tree_to(params, cuda)
    rng = np.random.RandomState(0)
    s = 96
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, s + 4)))
    before = (fa.flash_attention.launches, fd.flash_decode.launches)
    with torch.no_grad():
        lg, cg = gpu.prefill(params_gpu, {"tokens": toks[:, :s].to(cuda)})
        lc, cc = cpu.prefill(params, {"tokens": toks[:, :s]})
        assert (lg.cpu() - lc).abs().max().item() <= 1e-3
        cg, cc = gpu.alloc_cache(2, s + 3, init=cg), cpu.alloc_cache(
            2, s + 3, init=cc)
        for i in range(3):
            tok = toks[:, s + i:s + i + 1]
            lg, cg = gpu.decode_step(params_gpu, cg, tok.to(cuda), s + i)
            lc, cc = cpu.decode_step(params, cc, tok, s + i)
            assert (lg.cpu() - lc).abs().max().item() <= 1e-3
    assert (fa.flash_attention.launches - before[0],
            fd.flash_decode.launches - before[1]) == (
        cfg.num_layers, 3 * cfg.num_layers)
    batch = {"tokens": toks[:, :s], "targets": toks[:, 1:s + 1]}
    out = []
    for model, p in ((gpu, params_gpu), (cpu, params)):
        leaves = [x.detach().requires_grad_() for _p, x in iter_leaves(p)]
        it = iter(leaves)

        def build(node):
            return {k: build(node[k]) if isinstance(node[k], dict)
                    else next(it) for k in sorted(node)}
        loss, _m = model.train_loss(build(p), {
            k: v.to(model.device) for k, v in batch.items()})
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    (loss_g, grads_g), (loss_c, grads_c) = out
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, c in zip(grads_g, grads_c):
        assert (a.cpu() - c).abs().max().item() <= \
            1e-4 * max(c.abs().max().item(), 1e-30)


# ------------------------------------ MLA: v narrower than q and k (K1-K3)

# DeepSeek-V2's heads, q/k 128 + 64 and v 128 (the compiled pair (192,
# 128)), and the narrow test variant (48, 32) at (64, 64), at one kv head
# too (the absorbed route's layout), and the absorbed route's full width
# (576, 512) at G 16 (csrc/flash_attention_wide.cu)
MLA_CASES = [  # b, h, kh, sq, sk, hd, hd_v, dtype, window, q_offset
    (1, 8, 8, 300, 300, 192, 128, torch.bfloat16, 0, 0),
    (1, 8, 8, 257, 400, 192, 128, torch.float32, 0, 143),
    (1, 4, 4, 600, 600, 192, 128, torch.bfloat16, 200, 0),
    (2, 8, 8, 200, 200, 48, 32, torch.bfloat16, 0, 0),
    (2, 8, 1, 150, 150, 48, 32, torch.float32, 0, 0),
    (2, 4, 2, 333, 333, 48, 32, torch.bfloat16, 64, 0),
    # the absorbed route at full width, one kv head: (576, 512)
    (2, 16, 1, 300, 300, 576, 512, torch.bfloat16, 0, 0),
    (1, 16, 1, 257, 400, 576, 512, torch.float32, 0, 143),
    (1, 16, 1, 600, 600, 576, 512, torch.bfloat16, 100, 0),
]


@pytest.mark.parametrize("b,h,kh,sq,sk,hd,hd_v,dtype,window,q_offset",
                         MLA_CASES)
def test_mla_widths_kernels_match_plain(cuda, b, h, kh, sq, sk, hd, hd_v,
                                        dtype, window, q_offset):
    """K1, K1-lse, K2 and K3 at hd_v != hd against the plain versions;
    the output and dv are hd_v wide; K2 gives the same bits twice and K3
    K2's dk and dv."""
    q = _randn((b, h, sq, hd), dtype, cuda, 0)
    k = _randn((b, kh, sk, hd), dtype, cuda, 1)
    v = _randn((b, kh, sk, hd_v), dtype, cuda, 2)
    do = _randn((b, h, sq, hd_v), dtype, cuda, 6)
    kw = dict(causal=True, window=window)
    got = fa.flash_attention(q, k, v, q_offset, **kw)
    out, lse = fa.flash_attention_fwd(q, k, v, q_offset, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, q_offset,
                                                  with_lse=True, **kw)
    assert got.shape == out.shape == (b, h, sq, hd_v)
    for o in (got, out):
        assert (o.float() - want_out.float()).abs().max().item() <= \
            TOL[dtype]
    _close(lse, want_lse, (1e-5, 1e-4))
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, q_offset)
    dq2 = fa.flash_attention_bwd_dq(*args, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args, **kw)
    dq3, dk3, dv3 = fa.flash_attention_bwd_fused(*args, **kw)
    again = (fa.flash_attention_bwd_dq(*args, **kw),
             *fa.flash_attention_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, q_offset,
                                        causal=True, window=window)
    for got2, got3, w, ref in zip((dq2, dk2, dv2), (dq3, dk3, dv3), want,
                                  (q, k, v)):
        assert got2.shape == got3.shape == w.shape == ref.shape
        _close(got2, w, BWD_TOL[dtype])
        _close(got3, w, BWD_TOL[dtype])
    assert all(torch.equal(a, c) for a, c in zip(again, (dq2, dk2, dv2)))
    assert torch.equal(dk2, dk3) and torch.equal(dv2, dv3)


WIDE_CASES = [c for c in MLA_CASES if (c[5], c[6]) == autotune.WIDE_PAIR]


@pytest.mark.parametrize("b,h,kh,sq,sk,hd,hd_v,dtype,window,q_offset",
                         WIDE_CASES)
def test_wide_kernels_take_v_as_k_prefix(cuda, b, h, kh, sq, sk, hd, hd_v,
                                         dtype, window, q_offset):
    """At (576, 512) the absorbed route hands v as k's first 512 columns:
    K1, K1-lse, K2 and K3 on that view against the plain versions; the
    outputs equal those of the same values in a v of their own up to the
    summation order; K2 twice the same bits, K3's dk and dv K2's, and in
    bf16 K3's dq (no atomics) twice the same bits."""
    q = _randn((b, h, sq, hd), dtype, cuda, 0)
    k = _randn((b, kh, sk, hd), dtype, cuda, 1)
    v = k[..., :hd_v]
    assert fa.is_k_prefix(k, v) and not v.is_contiguous()
    do = _randn((b, h, sq, hd_v), dtype, cuda, 6)
    kw = dict(causal=True, window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, q_offset, **kw)
    got = fa.flash_attention(q, k, v, q_offset, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, q_offset,
                                                  with_lse=True, **kw)
    for o in (got, out):
        assert (o.float() - want_out.float()).abs().max().item() <= \
            TOL[dtype]
    _close(lse, want_lse, (1e-5, 1e-4))
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, q_offset)
    dq2 = fa.flash_attention_bwd_dq(*args, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args, **kw)
    dq3, dk3, dv3 = fa.flash_attention_bwd_fused(*args, **kw)
    again = (fa.flash_attention_bwd_dq(*args, **kw),
             *fa.flash_attention_bwd_dkv(*args, **kw),
             fa.flash_attention_bwd_fused(*args, **kw)[0])
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, q_offset,
                                        causal=True, window=window)
    for got2, got3, w in zip((dq2, dk2, dv2), (dq3, dk3, dv3), want):
        assert got2.is_contiguous() and got3.shape == w.shape
        _close(got2, w, BWD_TOL[dtype])
        _close(got3, w, BWD_TOL[dtype])
    assert all(torch.equal(a, c) for a, c in zip(again[:3], (dq2, dk2, dv2)))
    assert torch.equal(dk2, dk3) and torch.equal(dv2, dv3)
    if dtype == torch.bfloat16:
        assert torch.equal(again[3], dq3)


def test_wide_k3_passes_give_one_pass_bits(cuda, monkeypatch):
    """K3 at (576, 512) in bf16 with the dS workspace's cap lowered so
    that it runs several passes: the same bits as one pass (the dk
    blocks resume their partial sums in K2's order; dq is summed per q
    tile)."""
    b, h, s = 1, 16, 1100
    q = _randn((b, h, s, 576), torch.bfloat16, cuda, 5)
    k = _randn((b, 1, s, 576), torch.bfloat16, cuda, 6)
    v = k[..., :512]
    do = _randn((b, h, s, 512), torch.bfloat16, cuda, 7)
    out, lse = fa.flash_attention_fwd(q, k, v)
    args = (q, k, v, do, lse, (do.float() * out.float()).sum(-1))
    one = fa.flash_attention_bwd_fused(*args)
    cap = 40 * b * h * autotune.WIDE_DS_PAIR_BYTES
    assert len(autotune.wide_ds_passes(b * h, s, s, 0, True, 0, cap)) > 1
    real = autotune.wide_ds_passes
    monkeypatch.setattr(autotune, "wide_ds_passes",
                        lambda *a: real(*a, cap))
    many = fa.flash_attention_bwd_fused(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(one, many))


def test_wrappers_refuse_widths_no_pair_holds(cuda):
    """Widths past the widest compiled pair, (576, 512): ``ValueError``
    naming both widths, no launch."""
    before = fa.flash_attention.launches
    for hd, hd_v in ((584, 512), (64, 520)):
        q = torch.zeros((1, 2, 8, hd), device=cuda, dtype=torch.bfloat16)
        v = torch.zeros((1, 1, 8, hd_v), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=f"head_dim {hd}, v head_dim "
                           f"{hd_v}"):
            fa.flash_attention(q, q[:, :1], v)
    assert fa.flash_attention.launches == before


def test_mla_model_on_the_card_matches_the_cpu(cuda):
    """Reduced fp32 deepseek with MLA at q/k 48 and v 32
    (``attn_flash_min_seq=32``): prefill of 2 x 96 through K1 at (48,
    32), three latent-space decode steps, and one ``train_loss`` with its
    gradients through K1-lse and K3, on the card against the CPU's plain
    path from the same weights; logits 1e-3, loss 1e-5 relative,
    gradients 1e-4 of each leaf's largest entry."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim.adamw import iter_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32, attn_flash_min_seq=32)
    gpu, cpu = LanguageModel(cfg, device=cuda), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_gpu = _tree_to(params, cuda)
    rng = np.random.RandomState(0)
    s = 96
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, s + 4)))
    before = (fa.flash_attention.launches, fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_fused.launches)
    with torch.no_grad():
        lg, cg = gpu.prefill(params_gpu, {"tokens": toks[:, :s].to(cuda)})
        lc, cc = cpu.prefill(params, {"tokens": toks[:, :s]})
        assert (lg.cpu() - lc).abs().max().item() <= 1e-3
        cg, cc = gpu.alloc_cache(2, s + 3, init=cg), cpu.alloc_cache(
            2, s + 3, init=cc)
        for i in range(3):
            tok = toks[:, s + i:s + i + 1]
            lg, cg = gpu.decode_step(params_gpu, cg, tok.to(cuda), s + i)
            lc, cc = cpu.decode_step(params, cc, tok, s + i)
            assert (lg.cpu() - lc).abs().max().item() <= 1e-3
    for part in cc:
        for name in ("c_kv", "k_rope"):
            assert (cg[part][name].cpu() - cc[part][name]).abs().max() \
                .item() <= 1e-4
    batch = {"tokens": toks[:, :s], "targets": toks[:, 1:s + 1]}
    out = []
    for model, p in ((gpu, params_gpu), (cpu, params)):
        leaves = [x.detach().requires_grad_() for _p, x in iter_leaves(p)]
        it = iter(leaves)

        def build(node):
            return {k: build(node[k]) if isinstance(node[k], dict)
                    else next(it) for k in sorted(node)}
        loss, _m = model.train_loss(build(p), {
            k: v.to(model.device) for k, v in batch.items()})
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    layers = cfg.num_layers
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention_fwd.launches - before[1],
            fa.flash_attention_bwd_fused.launches - before[2]) == (
        layers, 2 * layers, layers)
    (loss_g, grads_g), (loss_c, grads_c) = out
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, c in zip(grads_g, grads_c):
        assert (a.cpu() - c).abs().max().item() <= \
            1e-4 * max(c.abs().max().item(), 1e-30)


def test_mla_absorbed_route_on_the_card_matches_the_cpu(cuda):
    """The absorbed MLA route with the kernel widths at full size:
    reduced deepseek with kv_lora_rank 512, q/k 128 + 64, v 128 and 16
    heads (one latent kv head of (576, 512) for 16 query heads),
    ``attn_flash_min_seq=32``; ``mla_prefill`` of 2 x 96 (K1 once) and
    ``mla_train`` with the gradients of sum(sin(out)) (K1-lse and K3
    once each) in fp32 on the card against the CPU from the same
    weights; the limits of the model test above: outputs 1e-3, caches
    1e-4, loss 1e-5 relative, gradients 1e-4 of each leaf's largest
    entry."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as TA

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        get_config("deepseek-v2-236b").reduced(), kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        num_heads=16, attn_flash_min_seq=32)
    params = TA.mla_init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.RandomState(3)
    b, s = 2, 96
    assert s > TA.flash_min_seq(cfg)
    x = torch.from_numpy(rng.randn(b, s, cfg.d_model).astype(np.float32))
    pos = torch.arange(s)[None].expand(b, s)
    params_gpu = _tree_to(params, cuda)
    before = (fa.flash_attention.launches, fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_fused.launches)
    with torch.no_grad():
        og, cg = TA.mla_prefill(params_gpu, x.to(cuda), cfg, pos.to(cuda))
        oc, cc = TA.mla_prefill(params, x, cfg, pos)
    assert (og.cpu() - oc).abs().max().item() <= 1e-3
    for name in ("c_kv", "k_rope"):
        assert (cg[name].cpu() - cc[name]).abs().max().item() <= 1e-4
    out = []
    for p, xx in ((params_gpu, x.to(cuda)), (params, x)):
        # every leaf (the norms' scales too) and x, as gradient leaves
        leaf = {k: (v["scale"] if isinstance(v, dict) else v).detach()
                .requires_grad_() for k, v in p.items()}
        tree = {k: {"scale": leaf[k]} if isinstance(v, dict) else leaf[k]
                for k, v in p.items()}
        xg = xx.detach().requires_grad_()
        loss = torch.sin(TA.mla_train(tree, xg, cfg, pos.to(xx.device))).sum()
        out.append((loss.item(), torch.autograd.grad(
            loss, [*leaf.values(), xg])))
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention_fwd.launches - before[1],
            fa.flash_attention_bwd_fused.launches - before[2]) == (1, 1, 1)
    (loss_g, grads_g), (loss_c, grads_c) = out
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, c in zip(grads_g, grads_c):
        assert (a.cpu() - c).abs().max().item() <= \
            1e-4 * max(c.abs().max().item(), 1e-30)


# ------------------------------------------- whisper and llava (G 1, hd 64)

@pytest.mark.parametrize("b,sq,dtype,window", [
    (1, 1100, torch.bfloat16, 0),
    (2, 333, torch.float32, 0),
    (1, 700, torch.bfloat16, 256),
])
def test_whisper_shape_kernels_match_plain(cuda, b, sq, dtype, window):
    """whisper-small's decoder self-attention: 12 heads over 12 kv heads
    (G 1) of width 64.  K1, K1-lse, K2 and K3 against their plain
    versions; K1 and K2 twice the same bits, K3 K2's dk and dv."""
    h = kh = 12
    q = _randn((b, h, sq, 64), dtype, cuda, 10)
    k = _randn((b, kh, sq, 64), dtype, cuda, 11)
    v = _randn((b, kh, sq, 64), dtype, cuda, 12)
    do = _randn((b, h, sq, 64), dtype, cuda, 13)
    kw = dict(causal=True, window=window)
    got = fa.flash_attention(q, k, v, **kw)
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True,
                                                  **kw)
    for o in (got, out):
        assert (o.float() - want_out.float()).abs().max().item() <= \
            TOL[dtype]
    _close(lse, want_lse, (1e-5, 1e-4))
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    dq2 = fa.flash_attention_bwd_dq(*args, **kw)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args, **kw)
    dq3, dk3, dv3 = fa.flash_attention_bwd_fused(*args, **kw)
    again = (fa.flash_attention_bwd_dq(*args, **kw),
             *fa.flash_attention_bwd_dkv(*args, **kw))
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                                        window=window)
    for got2, got3, w in zip((dq2, dk2, dv2), (dq3, dk3, dv3), want):
        _close(got2, w, BWD_TOL[dtype])
        _close(got3, w, BWD_TOL[dtype])
    assert all(torch.equal(a, c) for a, c in zip(again, (dq2, dk2, dv2)))
    assert torch.equal(dk2, dk3) and torch.equal(dv2, dv3)


@pytest.mark.parametrize("cur,dtype", [(449, torch.bfloat16),
                                       (480, torch.bfloat16),
                                       (300, torch.float32)])
def test_whisper_shape_decode_matches_plain(cuda, cur, dtype):
    """K5 at whisper's decode: B 4, 12 kv heads of one query head each (G
    1), hd 64, a 480-position cache; twice the same bits."""
    q = _randn((4, 12, 1, 64), dtype, cuda, 20)
    kc = _randn((4, 12, 480, 64), dtype, cuda, 21)
    vc = _randn((4, 12, 480, 64), dtype, cuda, 22)
    cur_t = torch.full((1,), cur, dtype=torch.int32, device=cuda)
    got = fd.flash_decode(q, kc, vc, cur_t)
    assert torch.equal(got, fd.flash_decode(q, kc, vc, cur_t))
    want = fd.flash_decode_plain(q, kc, vc, cur_t)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-mistral-7b"])
def test_encdec_and_vlm_models_on_the_card_match_the_cpu(cuda, arch):
    """Reduced fp32 whisper (24 frames) and llava (8 patches before the
    text, window 16) with ``attn_flash_min_seq=32``: prefill of 2 x 96
    positions through K1, three decode steps through K5 (at ``cur_len``
    counting the patches), and one ``train_loss`` with its gradients
    through K1-lse and K3, on the card against the CPU's plain path from
    the same weights; logits 1e-3, caches 1e-4, loss 1e-5 relative,
    gradients 1e-4 of each leaf's largest entry."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim.adamw import iter_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              attn_flash_min_seq=32)
    gpu, cpu = LanguageModel(cfg, device=cuda), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_gpu = _tree_to(params, cuda)
    rng = np.random.RandomState(0)
    if cfg.family == "encdec":
        key, width, pre = "frames", cfg.encoder_seq, 0
    else:
        key, width, pre = "patches", cfg.num_patches, cfg.num_patches
    s = 96 - pre
    extra = torch.from_numpy((0.02 * rng.randn(2, width, cfg.d_model))
                             .astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, s + 4)))
    counters = (fa.flash_attention, fd.flash_decode, fa.flash_attention_fwd,
                fa.flash_attention_bwd_fused)
    before = [c.launches for c in counters]
    with torch.no_grad():
        lg, cg = gpu.prefill(params_gpu, {"tokens": toks[:, :s].to(cuda),
                                          key: extra.to(cuda)})
        lc, cc = cpu.prefill(params, {"tokens": toks[:, :s], key: extra})
        assert (lg.cpu() - lc).abs().max().item() <= 1e-3
        cg, cc = gpu.alloc_cache(2, 99, init=cg), cpu.alloc_cache(
            2, 99, init=cc)
        for i in range(3):
            tok = toks[:, s + i:s + i + 1]
            lg, cg = gpu.decode_step(params_gpu, cg, tok.to(cuda),
                                     pre + s + i)
            lc, cc = cpu.decode_step(params, cc, tok, pre + s + i)
            assert (lg.cpu() - lc).abs().max().item() <= 1e-3
    for name, leaf in cc["layers"].items():
        assert (cg["layers"][name].cpu() - leaf).abs().max().item() <= 1e-4
    batch = {"tokens": toks[:, :s], "targets": toks[:, 1:s + 1], key: extra}
    out = []
    for model, p in ((gpu, params_gpu), (cpu, params)):
        leaves = [x.detach().requires_grad_() for _p, x in iter_leaves(p)]
        it = iter(leaves)

        def build(node):
            return {k: build(node[k]) if isinstance(node[k], dict)
                    else next(it) for k in sorted(node)}
        loss, metrics = model.train_loss(build(p), {
            k: v.to(model.device) for k, v in batch.items()})
        assert float(metrics["tokens"]) == 2 * s
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    layers = cfg.num_layers
    assert [c.launches - n for c, n in zip(counters, before)] == \
        [layers, 3 * layers, 2 * layers, layers]
    (loss_g, grads_g), (loss_c, grads_c) = out
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, c in zip(grads_g, grads_c):
        assert (a.cpu() - c).abs().max().item() <= \
            1e-4 * max(c.abs().max().item(), 1e-30)


@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (4, 64, 4096, 64, 128, 128), (1, 5, 100, 32, 16, 16),
    (2, 9, 70, 64, 64, 64), (1, 3, 40, 8, 8, 128)])
@pytest.mark.parametrize("own", [False, True])
def test_k9b_workspace_size_mirrors_the_kernel(cuda, b, h, s, p, n, chunk,
                                               own):
    """The meta route sizes K9b's workspace in Python: the C entry's
    bytes."""
    import ctypes
    from repro_torch.kernels import _build
    size = ctypes.c_longlong(0)
    _build.check(_build.load().repro_ssd_scan_bwd_workspace(
        b, h, s, p, n, chunk, int(own), ctypes.byref(size)), "workspace")
    assert ssd.bwd_workspace_bytes(b, h, s, p, n, chunk, own) == size.value


def test_launches_count_what_the_meta_route_counts(cuda):
    """A kernel on the card adds to ``kernels.counts`` exactly what its
    meta route adds for the same shapes (the dry run's prediction)."""
    from repro_torch.kernels import counts

    def run(device):
        counts.reset()
        bf = torch.bfloat16
        q = _randn((2, 8, 300, 64), bf, device, 1).requires_grad_(True)
        k = _randn((2, 2, 300, 64), bf, device, 2).requires_grad_(True)
        v = _randn((2, 2, 300, 64), bf, device, 3).requires_grad_(True)
        out = fa.flash_attention(q, k, v, block_q=64, block_k=64)
        torch.autograd.grad(out.float().sum(), (q, k, v))
        qd = _randn((2, 2, 4, 64), bf, device, 4)
        kc = _randn((2, 2, 300, 64), bf, device, 5)
        cur = torch.full((1,), 250, dtype=torch.int32, device=device)
        fd.flash_decode(qd, kc, kc, cur)
        x, dt, A, B, C = _ssd_inputs(2, 4, 96, 32, 16, bf, device, 6)
        x.requires_grad_(True)
        y, _ = ssd.ssd_scan(x, dt, A, B, C, chunk=32)
        torch.autograd.grad(y.float().sum(), (x,))
        return {k_: list(v_) for k_, v_ in counts.KERNELS.items()}

    on_card = run(cuda)
    assert set(on_card) == {"k1_lse", "k3", "k5", "k9", "k9b"}
    assert run(torch.device("meta")) == on_card


# The bf16 wgmma kernels at (64, 64) and (128, 128)
# (csrc/flash_attention_hopper.cu): K1 / K1-lse, K2's dk/dv and K3 at hd
# 32, 64, 120 and 128, G 1, 3 and 7, with a window, q_offset, ragged Sq /
# Sk and Sk shorter than one 128-row kv tile, against the plain versions;
# K2's dk/dv twice the same bits and equal to K3's
HOPPER_CASES = [  # b, h, kh, sq, sk, hd, window, q_offset
    (1, 3, 3, 300, 300, 64, 0, 0),       # G 1, ragged
    (2, 6, 2, 257, 257, 64, 0, 0),       # G 3
    (1, 14, 2, 400, 400, 128, 0, 0),     # G 7
    (1, 7, 1, 300, 500, 120, 0, 200),    # hd 120, q_offset, Sq < Sk
    (2, 4, 2, 333, 333, 32, 100, 0),     # hd 32, window
    (1, 6, 2, 1000, 1000, 128, 300, 0),  # window past a tile
    (1, 3, 1, 40, 50, 64, 0, 10),        # Sk < a tile
    (1, 14, 2, 90, 100, 128, 64, 10),    # Sk < a tile, window
]


@pytest.mark.parametrize("b,h,kh,sq,sk,hd,window,q_offset", HOPPER_CASES)
def test_wgmma_kernels_match_plain(cuda, b, h, kh, sq, sk, hd, window,
                                   q_offset):
    dt = torch.bfloat16
    assert autotune.attn_route(hd, hd, 2) == "wgmma"
    q = _randn((b, h, sq, hd), dt, cuda, 10)
    k = _randn((b, kh, sk, hd), dt, cuda, 11)
    v = _randn((b, kh, sk, hd), dt, cuda, 12)
    do = _randn((b, h, sq, hd), dt, cuda, 13)
    kw = dict(causal=True, window=window)
    out1 = fa.flash_attention(q, k, v, q_offset, **kw)
    out, lse = fa.flash_attention_fwd(q, k, v, q_offset, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, q_offset,
                                                  with_lse=True, **kw)
    for got in (out1, out):
        assert (got.float() - want_out.float()).abs().max().item() \
            <= TOL[dt]
    _close(lse, want_lse, (1e-5, 1e-4))
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, q_offset)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args, **kw)
    again = fa.flash_attention_bwd_dkv(*args, **kw)
    dq3, dk3, dv3 = fa.flash_attention_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, q_offset,
                                        causal=True, window=window)
    for got, w in zip((dq3, dk3, dv3, dk2, dv2), want + want[1:]):
        _close(got, w, BWD_TOL[dt])
    assert torch.equal(dk2, again[0]) and torch.equal(dv2, again[1])
    assert torch.equal(dk2, dk3) and torch.equal(dv2, dv3)


def test_wgmma_wrappers_refuse_a_misaligned_view(cuda):
    """TMA reads a tensor from a 16-byte aligned base: a view that starts
    2 bytes in is refused by the wrapper, not read wrongly."""
    dt = torch.bfloat16
    base = _randn((2 * 64 * 64 + 1,), dt, cuda, 14)
    q = base[1:].view(1, 2, 64, 64)   # contiguous, 2 bytes past the base
    assert q.is_contiguous() and q.data_ptr() % 16
    k = _randn((1, 1, 64, 64), dt, cuda, 15)
    for call in (lambda: fa.flash_attention(q, k, k),
                 lambda: fa.flash_attention_fwd(q, k, k)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
