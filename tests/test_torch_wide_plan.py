"""The (576, 512) pair's plans and its k-prefix v, on the CPU.

The absorbed MLA route hands the attention kernels v = c_kv as k's first
512 columns (k = [c_kv, k_rope]).  Here, without a card:

* the wrappers' meta route (the dry run's, ``launch.cost``) takes that
  view, refuses any other non-contiguous v, and counts the same work in
  ``counts.KERNELS`` as for a v of its own;
* ``autotune``'s plans for the wgmma kernels are pure functions of the
  shapes: every tile plan fits the 232,448 B a block may opt into, and
  K3's dS workspace passes cover every query tile once, from the last
  down, each under ``WIDE_DS_CAP`` (deepseek-v2-236b's micro-batch in one
  pass, 4 x 16384 in several).

``tests/test_torch_mla_absorbed.py`` holds the route itself against the
reference; ``tests/test_torch_cuda.py`` the kernels on the card.
"""
import pytest
import torch

from repro_torch.kernels import autotune, counts
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

HD, HD_V = autotune.WIDE_PAIR
B, H, S = 1, 16, 300


def _meta(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _work(v_of):
    """counts.KERNELS after one call of each wrapper on meta tensors, v
    from ``v_of(k)``."""
    q, k, do = _meta(B, H, S, HD), _meta(B, 1, S, HD), _meta(B, H, S, HD_V)
    v = v_of(k)
    lse = torch.empty((B, H, S), device="meta")
    counts.reset()
    outs = [fa.flash_attention_fwd(q, k, v), fa.flash_attention(q, k, v),
            fa.flash_attention_bwd_dq(q, k, v, do, lse, lse),
            fa.flash_attention_bwd_dkv(q, k, v, do, lse, lse),
            fa.flash_attention_bwd_fused(q, k, v, do, lse, lse)]
    return {n: list(w) for n, w in counts.KERNELS.items()}, outs


def test_meta_wrappers_take_k_prefix_and_count_the_same_work():
    view_work, outs = _work(lambda k: k[..., :HD_V])
    apart_work, _ = _work(lambda k: _meta(B, 1, S, HD_V))
    assert view_work == apart_work and set(view_work) == {
        "k1_lse", "k1", "k2_dq", "k2_dkv", "k3"}
    (o, lse), o1, dq, (dk, dv), (dq3, dk3, dv3) = outs
    assert o.shape == o1.shape == (B, H, S, HD_V) and lse.shape == (B, H, S)
    assert dq.shape == dq3.shape == (B, H, S, HD)
    assert dk.shape == dk3.shape == (B, 1, S, HD)
    assert dv.shape == dv3.shape == (B, 1, S, HD_V)
    assert dv.is_contiguous() and dv3.is_contiguous()


@pytest.mark.parametrize("v_of", [
    lambda k: k[..., 64:],                          # not k's first columns
    lambda k: k[..., :256],                         # k's prefix, too narrow
    lambda k: _meta(B, 1, HD_V, S).transpose(-1, -2),   # strides not k's
], ids=["offset", "narrow", "transposed"])
def test_meta_wrappers_refuse_other_noncontiguous_v(v_of):
    q, k = _meta(B, H, S, HD), _meta(B, 1, S, HD)
    v = v_of(k)
    assert not v.is_contiguous() and not fa.is_k_prefix(k, v)
    for call in (lambda: fa.flash_attention_fwd(q, k, v),
                 lambda: fa.flash_attention(q, k, v)):
        with pytest.raises(ValueError, match="v must be contiguous"):
            call()


def test_is_k_prefix_in_either_layout():
    """The model layout (B, S, KH, hd), where ops.flash_attention meets v,
    and the kernels' (B, KH, S, hd), where the wrappers do: both tell
    k's own prefix apart from a copy of the same values."""
    k = torch.randn(B, S, 1, HD)
    assert fa.is_k_prefix(k, k[..., :HD_V])
    assert not fa.is_k_prefix(k, k[..., :HD_V].clone())
    kt = k.transpose(1, 2).contiguous()
    assert fa.is_k_prefix(kt, kt[..., :HD_V])
    assert not fa.is_k_prefix(kt[..., :HD_V - 8], kt[..., :HD_V - 8])


def test_ops_hands_the_kernels_k_prefix(monkeypatch):
    """ops.flash_attention keeps the view through its transposes: the
    wrapper gets v as the transposed k's prefix, not a copy."""
    seen = []
    real = fa.flash_attention

    def record(q, k, v, *a, **kw):
        seen.append((k, v))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(fa, "flash_attention", record)
    q = torch.randn(B, 40, 2, HD)
    k = torch.randn(B, 40, 1, HD)
    out = ops.flash_attention(q, k, k[..., :HD_V])
    (kk, vv), = seen
    assert fa.is_k_prefix(kk, vv) and vv.shape == (B, 1, 40, HD_V)
    want = ops.flash_attention(q, k, k[..., :HD_V].contiguous())
    assert torch.equal(out, want)


def test_wide_tile_plans_fit_the_shared_memory():
    plans = autotune.wide_smem_bytes()
    assert set(plans) == {(n, sv) for n in ("k1", "dk", "dv", "dq")
                          for sv in (True, False)}
    assert all(0 < b <= autotune.SMEM_OPTIN_BYTES for b in plans.values())
    # one K / V tile a stage where v is k's prefix: more rows a stage
    assert autotune.WIDE_K1_ROWS[True] > autotune.WIDE_K1_ROWS[False]


def _pairs(sq, sk, q_offset, causal, window):
    tile = autotune.WIDE_DS_TILE
    return [autotune.wide_kv_tiles(q0, q_offset, sk, causal, window)
            for q0 in range(0, sq, tile)]


@pytest.mark.parametrize("bh,sq,sk,q_offset,causal,window,n_pass", [
    (128, 4096, 4096, 0, True, 0, 1),      # deepseek's micro-batch
    (4 * 128, 16384, 16384, 0, True, 0, 68),
    (16, 1100, 1300, 200, True, 0, 1),      # ragged, q_offset
    (16, 600, 600, 0, True, 100, 1),        # a window
    (8, 300, 300, 0, False, 0, 1),          # no mask
])
def test_ds_passes_cover_every_q_tile_under_the_cap(bh, sq, sk, q_offset,
                                                    causal, window, n_pass):
    passes = autotune.wide_ds_passes(bh, sq, sk, q_offset, causal, window)
    assert passes == autotune.wide_ds_passes(bh, sq, sk, q_offset, causal,
                                             window)
    assert len(passes) == n_pass
    tile = autotune.WIDE_DS_TILE
    # from the last q tiles down, contiguous, each a whole number of tiles
    assert passes[0][1] == -(-sq // tile) * tile and passes[-1][0] == 0
    for (lo, hi, pairs), nxt in zip(passes, passes[1:] + ((0, 0, 0),)):
        assert lo % tile == 0 and hi > lo and nxt[1] == (lo if nxt[1] else 0)
        want = sum(h - l for l, h in _pairs(sq, sk, q_offset, causal,
                                            window)[lo // tile:hi // tile])
        assert pairs == want
        assert bh * pairs * autotune.WIDE_DS_PAIR_BYTES <= \
            autotune.WIDE_DS_CAP
    if (bh, sq) == (128, 4096):   # 2,080 causal pairs a head, 4.36 GB
        assert passes[0][2] == 2080


def test_ds_passes_refuse_a_tile_past_the_cap():
    with pytest.raises(ValueError, match="past the cap"):
        autotune.wide_ds_passes(128, 4096, 4096, 0, True, 0,
                                cap=128 * autotune.WIDE_DS_PAIR_BYTES)
