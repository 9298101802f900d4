"""``repro_torch.launch.cost`` against programs of known cost (the port's
``tests/test_hlo_cost.py``), on the meta device.

* a matmul's FLOPs are exactly 2·m·k·n, and its bytes its operands' and
  result's;
* FLOPs and bytes grow with the layer count: a loop of matmuls n times
  over counts n times the FLOPs, and a reduced model's train step adds
  the same FLOPs for every layer it gains;
* a collective on a layout rank (a meta tensor under ``use_mesh(layout,
  rank=r)``) hands back the live call's shape and counts its bytes in
  ``TRAFFIC``, for the shapes given; a real tensor on a layout, or a
  meta one on a live mesh, raises;
* the peak tally follows storages as they are allocated and freed;
* each kernel wrapper's meta route counts its work (``kernels.counts``)
  and launches nothing.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (MeshLayout, ShardCtx, all_gather,
                                       all_reduce, current_ctx,
                                       reduce_scatter, use_mesh)
from repro_torch.kernels import counts
from repro_torch.launch import cost, dryrun


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_and_bytes_exact():
    m, k, n = 128, 256, 64
    _, rep = cost.measure(lambda a, b: a @ b, _meta(m, k), _meta(k, n))
    assert rep.flops == 2 * m * k * n
    assert rep.bytes == 4 * (m * k + k * n + m * n)
    assert rep.coll_total == 0 and rep.kernels == {}


@pytest.mark.parametrize("n", [2, 8])
def test_layer_loop_multiplies(n):
    def f(x, ws):
        for w in ws.unbind(0):          # views: no bytes
            x = torch.tanh(x @ w)
        return x

    _, rep = cost.measure(f, _meta(64, 64), _meta(n, 64, 64))
    assert rep.flops == n * 2 * 64 ** 3
    # each layer: the matmul reads 2 and writes 1 (64, 64) fp32 tensor,
    # tanh reads and writes one
    assert rep.bytes == n * 5 * 64 * 64 * 4


def test_train_step_flops_and_bytes_grow_per_layer():
    reps = {}
    for layers in (2, 3, 4):
        cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                                  num_layers=layers)
        reps[layers] = dryrun.trace_cell(
            cfg, ShapeConfig("t", 64, 4, "train"),
            MeshLayout((1, 1), ("data", "model")))[0]
    assert reps[4].flops - reps[3].flops == reps[3].flops - reps[2].flops > 0
    assert reps[4].bytes > reps[3].bytes > reps[2].bytes


LAYOUT = MeshLayout((2, 2), ("data", "model"))


@pytest.mark.parametrize("rank", [0, 3])
def test_layout_collectives_count_their_bytes(rank):
    sharding.reset_traffic()
    with use_mesh(LAYOUT, rank=rank) as ctx:
        assert ctx.coord("data") == rank // 2
        assert ctx.coord("model") == rank % 2
        x = _meta(4, 8, dtype=torch.bfloat16)
        g = all_gather(x, 1, "model", ctx)
        assert g.shape == (4, 16) and g.device.type == "meta"
        r = reduce_scatter(_meta(6, 8), 0, "model", ctx)
        assert r.shape == (3, 8)
        y = _meta(5)
        assert all_reduce(y, ("data", "model"), ctx) is y
        gp = all_gather(x, 0, ("data", "model"), ctx, kind="param_gather")
        assert gp.shape == (16, 8)
    assert sharding.TRAFFIC == {
        "all_gather/model": [1, 64, 64],
        "reduce_scatter/model": [1, 192, 192],
        "all_reduce/data": [1, 20, 20],
        "all_reduce/model": [1, 20, 20],
        "param_gather/model": [1, 64, 64],
        "param_gather/data": [1, 128, 128],
    }


def test_layout_refuses_real_tensors_and_live_meshes():
    with use_mesh(LAYOUT, rank=1):
        with pytest.raises(RuntimeError, match="meta tensors only"):
            all_reduce(torch.zeros(3), "model", current_ctx())
    live = ShardCtx(mesh=object())     # any mesh that is not a layout
    with pytest.raises(RuntimeError, match="live mesh"):
        sharding.on_layout(_meta(3), live)
    with use_mesh(LAYOUT):
        with pytest.raises(RuntimeError, match="rank="):
            current_ctx().coord("model")
    with pytest.raises(ValueError, match="rank="):
        use_mesh(None, rank=0)


def test_peak_tally_follows_storages():
    mb = 2 ** 20

    def f(x):
        y = x * 2                 # +1 MiB
        z = y + 1                 # +1 MiB: x, y, z live
        del y                     # -1 MiB
        w = z.view(-1)            # a view: no storage
        return (w * 3).sum()      # +1 MiB and the sum's 4 bytes; then
        #                           the product is freed

    _, rep = cost.measure(f, _meta(mb // 4))
    assert rep.arg_bytes == mb
    assert rep.peak_bytes == 3 * mb + 4
    assert rep.out_bytes == 4


def test_kernel_meta_routes_count_and_do_not_launch():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ssd
    bf = torch.bfloat16
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_fused.launches, fd.flash_decode.launches,
              ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches)
    q = _meta(2, 8, 256, 64, dtype=bf).requires_grad_(True)
    k = _meta(2, 2, 256, 64, dtype=bf).requires_grad_(True)
    v = _meta(2, 2, 256, 64, dtype=bf).requires_grad_(True)

    def attn(q, k, v):
        out = fa.flash_attention(q, k, v, block_q=64, block_k=64)
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    _, rep = cost.measure(attn, q, k, v)
    want = {n: counts.attention_work(n, 2, 8, 2, 256, 256, 64, 64, 0, True,
                                     0, 2) for n in ("k1_lse", "k3")}
    assert rep.kernels == {n: [1, *w] for n, w in want.items()}
    assert rep.kernel_flops == sum(w[0] for w in want.values())
    # K3's fp32 dq accumulator is allocated on the meta route too
    assert rep.peak_bytes >= rep.arg_bytes + 2 * 8 * 256 * 64 * 4

    qd = _meta(2, 2, 4, 64, dtype=bf)
    kc = _meta(2, 2, 300, 64, dtype=bf)
    cur = torch.empty(1, dtype=torch.int32, device="meta")
    out, rep = cost.measure(
        lambda *a: fd.flash_decode(*a, window=128), qd, kc, kc, cur)
    assert out.shape == qd.shape
    assert rep.kernels == {"k5": [1, *counts.decode_work(2, 2, 4, 128, 64,
                                                         2)]}

    b, h, s, p, n = 2, 4, 96, 32, 16
    x = _meta(b, h, s, p, dtype=bf).requires_grad_(True)
    dt = _meta(b, h, s).requires_grad_(True)
    A = _meta(h).requires_grad_(True)
    B = _meta(b, s, n, dtype=bf).requires_grad_(True)

    def scan(x, dt, A, B):
        y, st = ssd.ssd_scan(x, dt, A, B, B, chunk=32)
        assert y.shape == x.shape and st.shape == (b, h, p, n)
        return torch.autograd.grad(y.float().sum(), (x, dt, A, B))

    _, rep = cost.measure(scan, x, dt, A, B)
    assert rep.kernels == {
        "k9": [1, *counts.ssd_work(b, h, s, p, n, 32, 2)],
        "k9b": [1, *counts.ssd_bwd_work(b, h, s, p, n, 32, 2)]}
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_fused.launches, fd.flash_decode.launches,
            ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches) == before


# (PERF.md kernel-table row, what the count gives, bound ms as printed)
# bound = max(FLOP / 989 TFLOP/s, bytes / 3.35 TB/s)
_ROWS = [
    ("K1", ("k1", 1, 15, 5, 3008, 64, 64), 0.0176),
    ("K1-lse", ("k1_lse", 4, 15, 5, 4096, 64, 64), 0.1303),
    ("K2 dq", ("k2_dq", 4, 15, 5, 4096, 64, 64), 0.1955),
    ("K2 dk/dv", ("k2_dkv", 4, 15, 5, 4096, 64, 64), 0.2606),
    ("K3", ("k3", 4, 15, 5, 4096, 64, 64), 0.3258),
    ("K1 MLA", ("k1", 4, 128, 128, 4096, 192, 128), 2.7800),
    ("K1-lse MLA", ("k1_lse", 1, 128, 128, 4096, 192, 128), 0.6950),
    ("K2 dq MLA", ("k2_dq", 1, 128, 128, 4096, 192, 128), 1.1120),
    ("K2 dk/dv MLA", ("k2_dkv", 1, 128, 128, 4096, 192, 128), 1.3900),
    ("K3 MLA", ("k3", 1, 128, 128, 4096, 192, 128), 1.8070),
]


def _bound_ms(flops, nbytes):
    from repro_torch.launch.analysis import H100_BF16_FLOPS, H100_HBM_BYTES
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES) * 1e3


@pytest.mark.parametrize("row", _ROWS, ids=[r[0] for r in _ROWS])
def test_attention_counts_give_the_kernel_table_bounds(row):
    _name, (kern, b, h, kh, s, hd, hd_v), printed = row
    flops, nbytes = counts.attention_work(kern, b, h, kh, s, s, hd, hd_v, 0,
                                          True, 0, 2)
    assert abs(_bound_ms(flops, nbytes) - printed) <= 0.5e-4


def test_k1_count_is_the_table_gflop():
    flops, _ = counts.attention_work("k1", 1, 15, 5, 3008, 3008, 64, 64, 0,
                                     True, 0, 2)
    assert round(flops / 1e9, 1) == 17.4


@pytest.mark.parametrize("which,gflop,mb,printed", [
    ("k9", 60.3, 289.4, 0.0864), ("k9b", 121.2, 427.8, 0.1277)])
def test_ssd_counts_give_the_kernel_table_bounds(which, gflop, mb, printed):
    fn = counts.ssd_work if which == "k9" else counts.ssd_bwd_work
    flops, nbytes = fn(4, 64, 4096, 64, 128, 128, 2)
    assert round(flops / 1e9, 1) == gflop
    assert round(nbytes / 1e6, 1) == mb
    assert abs(_bound_ms(flops, nbytes) - printed) <= 0.5e-4


def test_shard_of_copies_into_storage_of_its_own():
    """A rank's shard of a leaf split on its leading dim is a slice that
    is already contiguous: it must not keep the whole leaf's storage."""
    from repro_torch.dist.sharding import NamedSharding, shard_of
    full = torch.arange(48.0).reshape(8, 6)
    sh = NamedSharding(MeshLayout((1, 2), ("data", "model")), ("model", None))
    for rank in (0, 1):
        part = shard_of(full, sh, rank)
        assert torch.equal(part, full[4 * rank:4 * rank + 4])
        assert part.untyped_storage().nbytes() == part.numel() * 4
        assert part.is_contiguous()


def test_shard_tree_consumes_the_whole_tree():
    from repro_torch.dist.sharding import NamedSharding, shard_tree
    sh = NamedSharding(MeshLayout((1, 2), ("data", "model")), ("model", None))
    a, c = torch.arange(8.0).reshape(4, 2), torch.arange(4.0).reshape(2, 2)
    whole = {"a": a, "b": {"c": c}}
    got = shard_tree(whole, {"a": sh, "b": {"c": sh}}, 1)
    assert whole == {}
    assert torch.equal(got["a"], a[2:]) and torch.equal(got["b"]["c"], c[1:])
