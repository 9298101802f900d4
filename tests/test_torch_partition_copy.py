"""The §6.3 partition copy on the CPU: the port's copy ops (the plain
versions behind K6, K7 and K8) and its ``Runtime(copy_backend="cuda",
copy_device="cpu")`` against the JAX package's ops (Pallas in interpret
mode) and ``Runtime(copy_backend="pallas")`` on the same inputs, bit for
bit.  Mirrors the copy tests of ``tests/test_kernels.py`` and the
``copy_backend`` tests of ``tests/test_hotpath.py``.  The staged (K8)
cases lower the staging threshold in both packages' modules for the
test, so the staged path runs on small buffers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NULL_GUID as J_NULL
from repro.core import Runtime as JRuntime
from repro.core import spawn_main as j_spawn
from repro.kernels import ops as jops
from repro.kernels import partition_copy as jpc
from repro_torch.core import DB_COPY_PARTITION, DB_COPY_PARTITION_BACK
from repro_torch.core import DB_PROP_NO_ACQUIRE, DbMode, EventKind
from repro_torch.core import NULL_GUID, UNINITIALIZED_GUID, Runtime, spawn_main
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels import partition_copy as pc

L = pc.LANES
STAGE = 64 * 1024        # lowered staging threshold for the K8 cases


def _both(fn_j, fn_t, dst, src, *args, **kw):
    """Run the JAX op (interpret mode) and the port's op on copies of the
    same numpy buffers; return (jax result, port result) as numpy."""
    want = fn_j(jnp.asarray(dst), jnp.asarray(src), *args, interpret=True,
                **kw)
    got = fn_t(torch.from_numpy(dst.copy()), torch.from_numpy(src.copy()),
               *args, **kw)
    return np.asarray(want), got.numpy()


def _expect(dst, src, ranges):
    out = dst.copy()
    for d_off, s_off, size in ranges:
        out[d_off:d_off + size] = src[s_off:s_off + size]
    return out


def _multi(dst, src, ranges):
    want, got = _both(jops.multi_partition_copy_bytes,
                      tops.multi_partition_copy_bytes, dst, src, ranges)
    expect = _expect(dst, src, ranges)
    assert np.array_equal(want, expect)
    assert np.array_equal(got, expect)


@pytest.fixture
def staged(monkeypatch):
    """Lower the staging threshold in both packages to 64 KiB."""
    monkeypatch.setattr(jpc, "DMA_STAGE_BYTES", STAGE)
    monkeypatch.setattr(pc, "DMA_STAGE_BYTES", STAGE)
    return monkeypatch


# --------------------------------------------------------------- the ops

@pytest.mark.parametrize("nblk_dst,nblk_src,dst_off,src_off,size", [
    (4, 4, 1, 2, 1),
    (8, 8, 0, 4, 2),
    (2, 6, 1, 0, 1),
])
def test_partition_copy(nblk_dst, nblk_src, dst_off, src_off, size):
    blk = 256 * L
    dst = np.zeros(nblk_dst * blk, np.uint8)
    src = (np.arange(nblk_src * blk) % 251).astype(np.uint8)
    kw = dict(dst_off=dst_off * blk, src_off=src_off * blk, size=size * blk)
    want, got = _both(jops.partition_copy_bytes, tops.partition_copy_bytes,
                      dst, src, **kw)
    expect = _expect(dst, src, ((kw["dst_off"], kw["src_off"], kw["size"]),))
    assert np.array_equal(want, expect) and np.array_equal(got, expect)


@pytest.mark.parametrize("ranges", [
    ((0, 128, 384),),
    ((128, 0, 256), (1024, 2048, 128), (4096, 512, 640)),
    ((0, 0, 128 * 300), (128 * 700, 128 * 350, 128 * 257)),
])
def test_multi_partition_copy_ragged(ranges):
    rng = np.random.default_rng(sum(r[0] for r in ranges))
    n = 128 * 1024
    _multi(rng.integers(0, 255, n).astype(np.uint8),
           rng.integers(0, 255, n).astype(np.uint8), ranges)


def test_multi_partition_copy_many_ranges_one_call():
    n = 64 * 1024
    ranges = tuple((i * 1024, ((i + 7) % 64) * 1024, 896) for i in range(64))
    _multi(np.zeros(n, np.uint8), (np.arange(n) % 251).astype(np.uint8),
           ranges)


@pytest.mark.parametrize("ranges,match", [
    (((0, 0, 512), (384, 1024, 256)), "overlap"),
    (((0, 0, 100),), "aligned"),
    (((3968, 0, 256),), "out of bounds"),
    (((0, 0, 0),), "empty"),
])
def test_multi_partition_copy_rejects_overlap_and_misalignment(ranges, match):
    dst, src = np.zeros(4096, np.uint8), np.ones(4096, np.uint8)
    for fn, d, s in ((jops.multi_partition_copy_bytes, jnp.asarray(dst),
                      jnp.asarray(src)),
                     (tops.multi_partition_copy_bytes, torch.from_numpy(dst),
                      torch.from_numpy(src))):
        kw = {"interpret": True} if fn is jops.multi_partition_copy_bytes \
            else {}
        with pytest.raises(ValueError, match=match):
            fn(d, s, ranges, **kw)


def test_overlapping_sources_are_a_gather():
    """Only destinations must be disjoint; two ranges may read the same
    source bytes."""
    ranges = ((0, 0, 256), (256, 0, 256))
    dst, src = np.zeros(4096, np.uint8), np.ones(4096, np.uint8)
    want, got = _both(jops.multi_partition_copy_bytes,
                      tops.multi_partition_copy_bytes, dst, src, ranges)
    assert np.array_equal(want, got) and got[:512].sum() == 512


def test_functional_contract_and_the_in_place_variant():
    """The functional op leaves dst alone and reads the original src even
    when src is dst itself (as the JAX op does); the in-place variant
    rejects a src that shares memory with dst."""
    buf = (np.arange(8192) % 251).astype(np.uint8)
    ranges = ((0, 1024, 512), (1024, 0, 1024))     # reads what it writes
    want = jops.multi_partition_copy_bytes(
        jnp.asarray(buf), jnp.asarray(buf), ranges, interpret=True)
    t = torch.from_numpy(buf.copy())
    got = tops.multi_partition_copy_bytes(t, t, ranges)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(t.numpy(), buf)
    with pytest.raises(ValueError, match="shares memory"):
        tops.multi_partition_copy_bytes_(t, t, ranges)
    with pytest.raises(ValueError, match="shares memory"):
        tops.multi_partition_copy_bytes_(t[:4096], t[2048:6144], ranges[:1])
    out = torch.from_numpy(buf.copy())
    assert tops.multi_partition_copy_bytes_(out, torch.from_numpy(buf.copy()),
                                            ranges) is out
    assert np.array_equal(out.numpy(), np.asarray(want))


def test_partition_copy_bytes_lane_aligned():
    n = 128 * 600
    rng = np.random.default_rng(3)
    dst = rng.integers(0, 255, n).astype(np.uint8)
    src = rng.integers(0, 255, n).astype(np.uint8)
    kw = dict(dst_off=128 * 3, src_off=128 * 11, size=128 * 257)
    want, got = _both(jops.partition_copy_bytes, tops.partition_copy_bytes,
                      dst, src, **kw)
    expect = _expect(dst, src, ((kw["dst_off"], kw["src_off"], kw["size"]),))
    assert np.array_equal(want, expect) and np.array_equal(got, expect)


def test_ragged_buffer_lengths():
    """Buffers whose length is not a multiple of 128 (the JAX op pads
    them; the port views their whole rows)."""
    rng = np.random.default_rng(4)
    dst = rng.integers(0, 255, 128 * 40 + 77).astype(np.uint8)
    src = rng.integers(0, 255, 128 * 30 + 5).astype(np.uint8)
    _multi(dst, src, ((128 * 39, 128 * 29, 128), (0, 128, 128 * 20)))


def test_partition_copy_routes_by_alignment(monkeypatch):
    """32 KiB-aligned copies take K6, anything else the multi-range
    kernel — proven by blowing up the path the call must not take."""
    blk = 256 * L
    dst, src = torch.zeros(4 * blk, dtype=torch.uint8), torch.ones(
        4 * blk, dtype=torch.uint8)

    def boom(*a, **kw):
        raise AssertionError("wrong copy path")

    monkeypatch.setattr(pc, "multi_partition_copy", boom)
    out = tops.partition_copy_bytes(dst, src, dst_off=blk, src_off=0,
                                    size=2 * blk)
    assert out[blk:3 * blk].all() and not out[:blk].any()
    monkeypatch.undo()
    monkeypatch.setattr(pc, "partition_copy", boom)
    out = tops.partition_copy_bytes(dst, src, dst_off=128, src_off=0,
                                    size=blk)
    assert out[128:blk + 128].all() and not out[:128].any()


# ------------------------------------------------------- the staged path

def _dma_buffers(extra_rows=4096, seed=0):
    """dst/src past the (lowered) staging threshold."""
    n = (STAGE // L + extra_rows) * L
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, 255, n, dtype=np.uint8)
    src = rng.integers(0, 255, n, dtype=np.uint8)
    assert jpc.dma_staged(n, n) and pc.dma_staged(n, n)
    return dst, src, n


def test_dma_staged_threshold_routing(monkeypatch):
    """Exactly at the threshold stays on the tile kernel; past it the
    staged kernel runs — proven by blowing up the path the call must NOT
    take, in both packages."""
    assert pc.DMA_STAGE_BYTES == jpc.DMA_STAGE_BYTES
    thr = pc.DMA_STAGE_BYTES
    assert not pc.dma_staged(thr, thr)
    assert pc.dma_staged(thr + 1, 0) and pc.dma_staged(0, thr + 1)

    def boom(*a, **kw):
        raise AssertionError("wrong copy path")

    def lower(not_jax, not_port):
        monkeypatch.setattr(jpc, "DMA_STAGE_BYTES", STAGE)
        monkeypatch.setattr(pc, "DMA_STAGE_BYTES", STAGE)
        monkeypatch.setattr(jpc, not_jax, boom)
        monkeypatch.setattr(pc, not_port, boom)

    lower("_multi_partition_copy_dma", "multi_partition_copy_staged")
    _multi(np.zeros(STAGE, np.uint8), np.ones(STAGE, np.uint8),
           ((0, 0, 512),))
    monkeypatch.undo()
    lower("_multi_partition_copy_impl", "multi_partition_copy_tiles")
    dst, src, _ = _dma_buffers(seed=1)
    _multi(dst, src, ((0, 128, 128 * 64),))


def test_multi_partition_copy_dma_bit_exact(staged):
    """Ragged, non-chunk-aligned ranges across the whole buffer: the head
    and tail of dst, the tail of src, an odd row count."""
    dst, src, n = _dma_buffers(seed=2)
    rows = n // L
    _multi(dst, src, (
        (0, 64 * L, 300 * L),
        (2500 * L, 0, 700 * L),
        ((rows - 501) * L, 3000 * L, 500 * L),
        (2000 * L, (rows - 129) * L, 128 * L),
        (1500 * L, 1500 * L, 257 * L),
    ))


def test_multi_partition_copy_dma_hazard_ordering(staged):
    """Overlapping sources gather from the original src; adjacent
    destination ranges and the gap rows between them survive (no edge
    write tears a neighbour); overlapping destinations are rejected."""
    dst, src, _ = _dma_buffers(seed=3)
    _multi(dst, src, (
        (0, 1000 * L, 512 * L),
        (1024 * L, 1000 * L, 512 * L),
        (1536 * L, 256 * L, 512 * L),
        (2049 * L, 256 * L, 511 * L),
    ))
    with pytest.raises(ValueError, match="overlap"):
        tops.multi_partition_copy_bytes(
            torch.from_numpy(dst), torch.from_numpy(src),
            ((0, 0, 512 * L), (256 * L, 2048 * L, 512 * L)))


@pytest.mark.parametrize("total", [1, 63, 64, 1000, 2048, 10 ** 6])
def test_plan_copy_chunk_fits_two_slots(total):
    chunk = autotune.plan_copy_chunk(total)
    assert chunk & (chunk - 1) == 0 and chunk >= autotune.MIN_CHUNK
    assert 2 * chunk * L <= autotune.SMEM_OPTIN_BYTES
    if total >= 4 * autotune.MIN_CHUNK:
        assert 2 * chunk <= total
    assert autotune.plan_copy_chunk(total, smem_budget=4096) == 16


# ------------------------------------------------------- the runtime path

PORT = dict(copy_backend="cuda", copy_device="cpu")


def _run(rt_cls, spawn, null, main_body, **kw):
    rt = rt_cls(**kw)
    out = {}

    def main(paramv, depv, api):
        main_body(api, out)
        return null

    spawn(rt, main)
    stats = rt.run()
    return rt, out, stats


def _both_runtimes(main_body):
    """The program under the JAX ``pallas`` backend, the port's ``cuda``
    backend on the CPU and the port's ``numpy`` backend."""
    return {name: _run(*cls, main_body, **kw) for name, cls, kw in (
        ("jax", (JRuntime, j_spawn, J_NULL), {"copy_backend": "pallas"}),
        ("port", (Runtime, spawn_main, NULL_GUID), PORT),
        ("numpy", (Runtime, spawn_main, NULL_GUID), {}))}


def _scatter_body(num_ranges, psize, ragged=False):
    size = psize * num_ranges

    def body(api, out):
        block, ptr = api.db_create(size)
        ptr[:] = np.frombuffer(np.random.default_rng(7).bytes(size), np.uint8)
        api.db_release(block)
        shadow, _ = api.db_create(size)
        api.db_release(shadow)
        for i in range(num_ranges):
            if ragged:
                api.db_copy(shadow, i * psize + 128 * (i % 3), block,
                            ((i + 7) % num_ranges) * psize, psize - 256)
            else:
                api.db_copy(shadow, i * psize, block, i * psize, psize)
        out["block"], out["shadow"] = block, shadow
    return body


def _buf(rt, out, key):
    return rt.lookup(out[key]).buffer.copy()


def _same_as_jax(runs, key, fused):
    bufs = [_buf(rt, out, key) for rt, out, _ in runs.values()]
    assert all(np.array_equal(bufs[0], b) for b in bufs[1:])
    stats = {k: s for k, (_, _, s) in runs.items()}
    assert stats["port"].fused_copies == stats["jax"].fused_copies == fused
    assert stats["numpy"].fused_copies == 0
    assert len({s.bytes_copied for s in stats.values()}) == 1
    return bufs[0], stats["port"]


def test_copy_batching_numpy_backend():
    rt, out, stats = _run(Runtime, spawn_main, NULL_GUID,
                          _scatter_body(8, 1024))
    assert np.array_equal(_buf(rt, out, "shadow"), _buf(rt, out, "block"))
    assert stats.bytes_copied == 8 * 1024 and stats.fused_copies == 0


def test_copy_batching_cuda_backend_matches():
    """The fused path collapses the batch into one launch and equals the
    JAX package's pallas backend and the numpy backend."""
    runs = _both_runtimes(_scatter_body(8, 1024))
    shadow, stats = _same_as_jax(runs, "shadow", fused=1)
    rt, out, _ = runs["port"]
    assert np.array_equal(shadow, _buf(rt, out, "block"))
    assert stats.bytes_copied == 8 * 1024


def test_sixty_four_partitions_take_the_tile_kernel(monkeypatch):
    """The §6 program of 64 ragged partitions runs as one fused copy
    through K7's path (K8's blown up)."""
    def boom(*a, **kw):
        raise AssertionError("wrong copy path")

    monkeypatch.setattr(pc, "multi_partition_copy_staged", boom)
    _same_as_jax(_both_runtimes(_scatter_body(64, 1024, ragged=True)),
                 "shadow", fused=1)


def test_sixty_four_partitions_take_the_staged_kernel(staged):
    """Past the (lowered) staging threshold the same program runs through
    K8's path in both packages (their tile kernels blown up)."""
    def boom(*a, **kw):
        raise AssertionError("wrong copy path")

    staged.setattr(jpc, "_multi_partition_copy_impl", boom)
    staged.setattr(pc, "multi_partition_copy_tiles", boom)
    _same_as_jax(_both_runtimes(_scatter_body(64, 2048, ragged=True)),
                 "shadow", fused=1)


def test_copy_completion_events_fire_after_flush():
    rt = Runtime(**PORT)
    seen = {}

    def check(paramv, depv, api):
        seen["data"] = depv[1].ptr.copy()
        return NULL_GUID

    def main(paramv, depv, api):
        src, sptr = api.db_create(256)
        sptr[:] = 3
        api.db_release(src)
        dst, _ = api.db_create(256)
        api.db_release(dst)
        ev1 = api.db_copy(dst, 0, src, 0, 128)
        ev2 = api.db_copy(dst, 128, src, 128, 128)
        latch = api.event_create(EventKind.LATCH, latch_count=2)
        api.add_dependence(ev1, latch, 0, DbMode.NULL)
        api.add_dependence(ev2, latch, 0, DbMode.NULL)
        tmpl = api.edt_template_create(check, 0, 2)
        t, _ = api.edt_create(tmpl,
                              depv=[UNINITIALIZED_GUID, UNINITIALIZED_GUID])
        api.add_dependence(latch, t, 0, DbMode.NULL)
        api.add_dependence(dst, t, 1, DbMode.RO)
        seen["dst"] = dst
        return NULL_GUID

    spawn_main(rt, main)
    stats = rt.run()
    assert (seen["data"] == 3).all()
    assert (rt.lookup(seen["dst"]).buffer == 3).all()
    assert stats.fused_copies == 1


def test_partition_back_not_batched():
    rt = Runtime(**PORT)
    out = {}

    def main(paramv, depv, api):
        block, ptr = api.db_create(256)
        ptr[:] = 9
        api.db_release(block)
        c, _ = api.db_create(128, props=DB_PROP_NO_ACQUIRE)
        api.db_copy(c, 0, block, 64, 128, DB_COPY_PARTITION)
        out["block"], out["chunk"] = block, c
        return NULL_GUID

    spawn_main(rt, main)
    rt.run()

    def main2(paramv, depv, api):
        api.db_copy(out["block"], 64, out["chunk"], 0, 128,
                    DB_COPY_PARTITION_BACK)
        return NULL_GUID

    spawn_main(rt, main2)
    rt.run()
    assert rt.try_lookup(out["chunk"]) is None
    assert not rt.lookup(out["block"]).partitions
    assert rt.stats.bytes_zero_copy == 256
    assert rt.stats.fused_copies == 0


def test_copy_then_same_timestamp_destroy():
    def body(api, out):
        block, ptr = api.db_create(1024)
        ptr[:] = 5
        api.db_release(block)
        shadow, _ = api.db_create(1024)
        api.db_release(shadow)
        api.db_copy(shadow, 0, block, 0, 512)
        api.db_copy(shadow, 512, block, 512, 512)
        api.db_destroy(block)
        out["shadow"] = shadow

    shadow, stats = _same_as_jax(_both_runtimes(body), "shadow", fused=1)
    assert (shadow == 5).all() and stats.bytes_copied == 1024


def test_overlapping_destinations_fall_back_to_sequential():
    def body(api, out):
        block, ptr = api.db_create(1024)
        ptr[:512] = 1
        ptr[512:] = 2
        api.db_release(block)
        shadow, _ = api.db_create(1024)
        api.db_release(shadow)
        api.db_copy(shadow, 0, block, 0, 512)
        api.db_copy(shadow, 256, block, 512, 512)   # overlaps first dst
        out["shadow"] = shadow

    shadow, _ = _same_as_jax(_both_runtimes(body), "shadow", fused=0)
    assert (shadow[256:768] == 2).all()             # last writer wins


def test_same_dst_different_sources_keeps_arrival_order():
    def body(api, out):
        s1, p1 = api.db_create(256)
        p1[:] = 1
        api.db_release(s1)
        s2, p2 = api.db_create(256)
        p2[:] = 2
        api.db_release(s2)
        d, _ = api.db_create(256)
        api.db_release(d)
        api.db_copy(d, 0, s1, 0, 256)
        api.db_copy(d, 0, s2, 0, 256)
        api.db_copy(d, 0, s1, 0, 256)   # issued last: s1 must win
        out["d"] = d

    d, _ = _same_as_jax(_both_runtimes(body), "d", fused=0)
    assert (d == 1).all()


def test_src_aliasing_dst_is_sequential():
    def body(api, out):
        b, ptr = api.db_create(4096)
        ptr[:] = 0
        ptr[:128] = 1
        api.db_release(b)
        api.db_copy(b, 1024, b, 0, 128)
        api.db_copy(b, 2048, b, 1024, 128)   # reads copy 1's dst
        out["b"] = b

    b, _ = _same_as_jax(_both_runtimes(body), "b", fused=0)
    assert (b[2048:2176] == 1).all()


def test_partition_view_source_reads_the_original():
    """A §6 partition is a view of its parent's buffer; copying it back
    into the parent in one batch must read the original bytes, as the
    JAX package's functional kernel does (the numpy backend's per-range
    replay reads what the first range wrote, in both packages)."""
    from repro.core import DB_COPY_PARTITION as J_PART
    from repro.core import DB_PROP_NO_ACQUIRE as J_NO_ACQ

    def run(rt, spawn, null, part, no_acq):
        out = {}

        def create(paramv, depv, api):
            b, ptr = api.db_create(1024)
            ptr[:] = (np.arange(1024) % 251).astype(np.uint8)
            api.db_release(b)
            c, _ = api.db_create(256, props=no_acq)
            api.db_copy(c, 0, b, 128, 256, part)     # view of b[128:384]
            out["b"], out["c"] = b, c
            return null

        def copy_back(paramv, depv, api):
            api.db_copy(out["b"], 256, out["c"], 0, 128)
            api.db_copy(out["b"], 512, out["c"], 128, 128)  # reads b[256:]
            return null

        spawn(rt, create)
        rt.run()
        spawn(rt, copy_back)
        stats = rt.run()
        return rt.lookup(out["b"]).buffer.copy(), stats.fused_copies

    want, j_fused = run(JRuntime(copy_backend="pallas"), j_spawn, J_NULL,
                        J_PART, J_NO_ACQ)
    got, t_fused = run(Runtime(**PORT), spawn_main, NULL_GUID,
                       DB_COPY_PARTITION, DB_PROP_NO_ACQUIRE)
    assert (j_fused, t_fused) == (1, 1)
    assert np.array_equal(got, want)
    orig = (np.arange(1024) % 251).astype(np.uint8)
    assert np.array_equal(got[512:640], orig[256:384])


def test_cuda_copy_backend_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime(copy_backend="cuda")
    with pytest.raises(ValueError):
        Runtime(copy_backend="cuda", copy_device="meta")
    rt = Runtime(**PORT)
    assert (rt.copy_backend, rt.copy_device) == ("cuda", "cpu")
