"""The port's copy of the §5 file layer against the reference's runtime.

The port's ``core`` keeps its live file chunks and its pending write-backs
in a :class:`~repro_torch.core.objects.SpanIndex` (sorted by offset)
instead of scanning every one for each new chunk and each flushed write,
so that a sharded checkpoint can map tens of thousands of ranges of one
file.  These tests hold the index against a linear scan, and the same
seeded write programs — adjacent ranges that coalesce, writes that queue
behind a busy disk and merge into it, and ranges rewritten through a
second file object while an older write-back is pending — against the
reference's runtime: the same bytes on disk and the same IO counters and
makespan.
"""
import os

import numpy as np
import pytest

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.core.objects import SpanIndex


def test_span_index_matches_a_linear_scan():
    rng = np.random.default_rng(0)
    index, live = SpanIndex(), {}
    for step in range(3000):
        if live and rng.random() < 0.4:
            key = list(live)[rng.integers(len(live))]
            index.remove(key)
            del live[key]
        else:
            off, size = int(rng.integers(0, 400)), int(rng.integers(0, 40))
            index.add(step, off, size)
            live[step] = (off, size)
        off, size = int(rng.integers(0, 440)), int(rng.integers(0, 40))
        assert sorted(index.overlapping(off, size)) == sorted(
            k for k, (o, s) in live.items() if off < o + s and o < off + size)
        assert sorted(index.touching(off, size)) == sorted(
            k for k, (o, s) in live.items()
            if o + s == off or o == off + size)
        assert len(index) == len(live)


def _openers(seed):
    """(node, [(offset, size, fill, duration)]) per opener: each opener's
    ranges are disjoint (one file object's chunks), tiling stretches of
    the file with gaps, in order or shuffled; their writers run for
    different virtual times, so write-backs retire at different times;
    some openers rewrite ranges another opener on the same node writes."""
    rng = np.random.default_rng(seed)
    nodes = int(rng.integers(1, 4))
    out = []
    for i in range(int(rng.integers(3, 7))):
        off, ranges = int(rng.integers(0, 64)), []
        for _ in range(int(rng.integers(5, 40))):
            size = int(rng.integers(1, 24))
            ranges.append((off, size, int(rng.integers(1, 255)),
                           float(rng.choice([0.5, 1.0, 2.0, 3.0]))))
            off += size + (0 if rng.random() < 0.6 else int(rng.integers(1, 9)))
        if rng.random() < 0.5:         # else in order: chains of merges
            rng.shuffle(ranges)
        out.append((int(rng.integers(nodes)), ranges))
    return nodes, out, float(rng.choice([1.0, 3.0, 8.0]))


def _run(core, path, seed):
    nodes, openers, latency = _openers(seed)
    with open(path, "wb") as f:
        f.truncate(1024)
    rt = core.Runtime(num_nodes=nodes, io_latency=latency, io_mode="async")

    def writer(paramv, depv, api):
        depv[0].ptr[:] = paramv[0]
        api.db_destroy(depv[0].guid)
        return core.NULL_GUID

    def opener(paramv, depv, api):
        node, ranges = paramv
        fg = api.file_get_guid(depv[0].ptr)
        wt = api.edt_template_create(writer, 1, 1)
        for off, size, fill, duration in ranges:
            chunk = api.file_get_chunk(fg, off, size, write_only=True)
            api.edt_create(wt, paramv=[fill], depv=[chunk],
                           dep_modes=[core.DbMode.EW], placement=node,
                           duration=duration)
        api.file_release(fg)
        api.db_destroy(depv[0].guid)
        return core.NULL_GUID

    def main(paramv, depv, api):
        ot = api.edt_template_create(opener, 2, 1)
        for node, ranges in openers:
            _fg, desc = api.file_open(path, "rb+")
            api.edt_create(ot, paramv=[node, ranges], depv=[desc],
                           placement=node)
        return core.NULL_GUID

    core.spawn_main(rt, main)
    rt.run()
    with open(path, "rb") as f:
        data = f.read()
    st = rt.stats
    return data, (st.io_write_ops, st.io_coalesced_writes, st.makespan,
                  st.file_bytes_written)


@pytest.mark.parametrize("seed", range(12))
def test_write_back_matches_reference_runtime(tmp_path, seed):
    got = _run(tcore, os.path.join(tmp_path, "port.bin"), seed)
    want = _run(jcore, os.path.join(tmp_path, "ref.bin"), seed)
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert want[1][1] > 0              # some write-backs coalesced
