"""The range descriptor that K7 and K8 read on the card, and the
vectorised range checks around them, on the CPU.

``range_descriptor``'s four columns, expanded entry by entry by a plain
Python copy of the kernels' search (``find_entry`` in
``csrc/partition_copy.cu``), give exactly the reference's
``repro.kernels.partition_copy._block_tables`` entries, in its order; the
route rule puts a set on the by-value route up to ``MAX_PARAM_RANGES``
ranges and on the card past it; the numpy range checks of the wrapper
and of ``ops`` raise what the reference's loops raise, and ``ops`` hands
its checked rows to the wrapper without checking them again."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.objects import spans_overlap
from repro.kernels import ops as jops
from repro.kernels import partition_copy as jpc
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels import partition_copy as pc

L = pc.LANES


def _expand(cols, total, entry_rows):
    """Every entry of a descriptor as the kernels find it: the last range
    whose first entry is at or before ``e``, by binary search."""
    dst, src, rows, first = (c.tolist() for c in cols)
    d_tab, s_tab, n_tab = [], [], []
    for e in range(total):
        lo, hi = 0, len(first) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if first[mid] <= e:
                lo = mid
            else:
                hi = mid - 1
        r0 = (e - first[lo]) * entry_rows
        d_tab.append(dst[lo] + r0)
        s_tab.append(src[lo] + r0)
        n_tab.append(min(entry_rows, rows[lo] - r0))
    return d_tab, s_tab, n_tab


def _same_as_reference(ranges, entry_rows):
    cols, total = pc.range_descriptor(ranges, entry_rows)
    assert cols.dtype == np.int32 and cols.shape == (4, len(ranges))
    want = jpc._block_tables(ranges, entry_rows)
    assert total == len(want[0])
    got = _expand(cols, total, entry_rows)
    for g, w in zip(got, want):
        assert g == w.tolist()


ragged = st.lists(st.tuples(st.integers(0, 1 << 20), st.integers(0, 1 << 20),
                            st.one_of(st.just(0), st.just(1),
                                      st.integers(0, 3000))),
                  min_size=1, max_size=2 * pc.MAX_PARAM_RANGES)


@settings(max_examples=60, deadline=None)
@given(ranges=ragged)
def test_descriptor_gives_the_reference_entries_at_256_rows(ranges):
    _same_as_reference(ranges, pc.BLOCK_ROWS)


@settings(max_examples=60, deadline=None)
@given(ranges=ragged)
def test_descriptor_gives_the_reference_entries_at_the_chunk(ranges):
    total = sum(r for _, _, r in ranges)
    _same_as_reference(ranges, autotune.plan_copy_chunk(total))


@pytest.mark.parametrize("ranges", [
    ((0, 0, 0),),                                   # one empty range
    ((0, 0, 0), (7, 3, 0), (9, 9, 1)),              # empties before a row
    ((0, 5, 1), (1, 0, 0), (2, 2, 0)),              # empties at the end
    ((0, 0, 256), (256, 0, 257), (600, 9, 255)),    # whole and edge tiles
    tuple((i * 13, (i * 7) % 300 * 13, 13 - i % 3)
          for i in range(pc.MAX_PARAM_RANGES + 1)),  # past the by-value cap
])
@pytest.mark.parametrize("entry_rows", [1, 16, pc.BLOCK_ROWS, 512])
def test_descriptor_edge_sets(ranges, entry_rows):
    _same_as_reference(ranges, entry_rows)


def test_descriptor_work_does_not_grow_with_entries():
    """2^31 - 1 one-row entries are described at once: no per-entry
    work."""
    cols, total = pc.range_descriptor(((0, 0, 2 ** 31 - 1),), 1)
    assert total == 2 ** 31 - 1 and cols[:, 0].tolist() == [0, 0,
                                                            2 ** 31 - 1, 0]
    cols, total = pc.range_descriptor((), 256)
    assert total == 0 and cols.shape == (4, 0)


def test_route_rule_at_the_cut_off():
    cap = pc.MAX_PARAM_RANGES
    assert pc.descriptor_route(1) == "param"
    assert pc.descriptor_route(cap) == "param"
    assert pc.descriptor_route(cap + 1) == "device"
    sets = {n: tuple((i, i, 1) for i in range(n)) for n in (cap, cap + 1)}
    at_cap = pc.descriptor(sets[cap], 256, "cpu")
    past = pc.descriptor(sets[cap + 1], 256, "cpu")
    assert (at_cap.route, at_cap.on_card) == ("param", None)
    assert past.route == "device"
    assert past.on_card.dtype == torch.int32
    assert np.array_equal(past.on_card.numpy(), past.cols)
    forced = pc.descriptor(sets[cap], 256, "cpu", route="device")
    assert forced.route == "device" and forced.total == cap
    with pytest.raises(ValueError, match="route"):
        pc.descriptor(sets[cap], 256, "cpu", route="table")


# ------------------------------------------------------------ the checks

def _loop_row_check(rows, nd, ns, what):
    """The wrapper's row checks before they were vectorised."""
    for (d0, s0, n) in rows:
        if n < 0 or d0 < 0 or s0 < 0 or d0 + n > nd or s0 + n > ns:
            raise ValueError(f"{what}: row range ({d0},{s0},{n}) out of "
                             f"bounds (dst {nd}, src {ns} rows)")
    if spans_overlap((d0, d0 + n) for d0, _, n in rows if n):
        raise ValueError(f"{what}: destination ranges overlap")


def _loop_byte_check(ranges, nd, ns):
    """``ops``'s byte checks before they were vectorised: the reference's
    loop (``repro.kernels.ops.multi_partition_copy_bytes``)."""
    out = []
    for (d_off, s_off, size) in ranges:
        if size <= 0:
            raise ValueError(f"empty copy range ({d_off},{s_off},{size})")
        if d_off % L or s_off % L or size % L:
            raise ValueError(
                f"range ({d_off},{s_off},{size}) not 128-byte aligned")
        if d_off + size > nd or s_off + size > ns or d_off < 0 or s_off < 0:
            raise ValueError(f"range ({d_off},{s_off},{size}) out of bounds "
                             f"(dst {nd}, src {ns})")
        out.append((d_off // L, s_off // L, size // L))
    if spans_overlap((d, d + n) for d, _, n in out):
        raise ValueError("destination ranges overlap")
    return out


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "raises", str(e)


@settings(max_examples=150, deadline=None)
@given(rows=st.lists(st.tuples(st.integers(-3, 70), st.integers(-3, 70),
                               st.integers(-2, 20)), max_size=8))
def test_row_checks_raise_as_the_loop_did(rows):
    nd, ns, what = 64, 72, "multi_partition_copy_tiles"
    want = _outcome(_loop_row_check, rows, nd, ns, what)
    got = _outcome(pc._check_ranges, pc.as_rows(rows), nd, ns, what)
    assert got[0] == want[0] and (got[0] == "ok" or got[1] == want[1])


@pytest.mark.parametrize("rows,overlap", [
    (((0, 0, 10), (5, 0, 0)), False),      # an empty range inside another
    (((5, 0, 0), (5, 9, 3), (0, 0, 5)), False),
    (((0, 0, 10), (9, 0, 1)), True),
    (((3, 0, 1), (3, 9, 1)), True),
])
def test_row_checks_ignore_empty_ranges(rows, overlap):
    nd, ns, what = 64, 72, "multi_partition_copy_staged"
    want = _outcome(_loop_row_check, rows, nd, ns, what)
    got = _outcome(pc._check_ranges, pc.as_rows(rows), nd, ns, what)
    assert want[0] == got[0] == ("raises" if overlap else "ok")


@settings(max_examples=150, deadline=None)
@given(ranges=st.lists(st.tuples(
    st.sampled_from([-128, 0, 64, 128, 256, 384, 1024, 3968, 4096]),
    st.sampled_from([-128, 0, 128, 200, 512, 4096]),
    st.sampled_from([-128, 0, 100, 128, 256, 512])), max_size=6))
def test_byte_checks_raise_as_the_reference_does(ranges):
    nd, ns = 4096, 4224
    want = _outcome(_loop_byte_check, ranges, nd, ns)
    got = _outcome(tops._row_ranges, ranges, nd, ns)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert got[1].tolist() == [list(r) for r in want[1]]
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("ranges", [
    ((0, 0, 512), (384, 1024, 256)),               # overlap
    ((0, 0, 128), (128, 0, 100)),                  # misaligned second
    ((0, 0, 128), (3968, 0, 256)),                 # out of bounds second
    ((0, 0, 0), (1, 0, 100)),                      # empty before misaligned
    ((3968, 0, 256), (0, 0, 100)),                 # bounds before misaligned
])
def test_byte_checks_raise_the_reference_message(ranges):
    """The same message as the reference's own op for the same set."""
    dst, src = np.zeros(4096, np.uint8), np.ones(4096, np.uint8)
    with pytest.raises(ValueError) as want:
        jops.multi_partition_copy_bytes(jnp.asarray(dst), jnp.asarray(src),
                                        ranges, interpret=True)
    with pytest.raises(ValueError) as got:
        tops.multi_partition_copy_bytes(torch.from_numpy(dst),
                                        torch.from_numpy(src), ranges)
    assert str(got.value) == str(want.value)


def test_ops_checks_the_ranges_once(monkeypatch):
    """``ops`` hands its checked rows to the wrapper, which checks the
    buffers but not the ranges again; a direct wrapper call checks
    both."""
    def boom(*a, **k):
        raise AssertionError("the ranges were checked twice")

    monkeypatch.setattr(pc, "_check_ranges", boom)
    n = 64 * 1024
    src = (np.arange(n) % 251).astype(np.uint8)
    ranges = tuple((i * 1024, ((i + 7) % 64) * 1024, 896) for i in range(64))
    got = tops.multi_partition_copy_bytes(torch.zeros(n, dtype=torch.uint8),
                                          torch.from_numpy(src), ranges)
    want = np.zeros(n, np.uint8)
    for d, s, size in ranges:
        want[d:d + size] = src[s:s + size]
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(AssertionError, match="twice"):
        pc.multi_partition_copy_tiles(torch.zeros(64, L, dtype=torch.uint8),
                                      torch.zeros(64, L, dtype=torch.uint8),
                                      ((0, 0, 8),))
