"""Quickstart on the PyTorch port: the OCR-extensions runtime of
``repro_torch.core`` in five minutes.

The same four demos as ``examples/quickstart.py``, printing the same
lines (the runtime runs on a virtual clock, so they do not depend on the
machine):
  §3 local identifiers (futures)    §6 data block partitioning
  §5 file-mapped data blocks        §6.3 zero-copy ``db_copy``

The §6 demos run on ``Runtime(copy_backend="cuda", copy_device=device)``:
a batch of lane-aligned §6.3 copies issued at one virtual time goes
through the fused copy kernel (K7, or K8 for a buffer past 16 MiB) on
the card, through its plain PyTorch version on the CPU.  The card is the
default; there is no fallback: without one the runtime raises.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import (DB_COPY_PARTITION, DB_PROP_NO_ACQUIRE, DbMode,
                              EDT_PROP_LID, NULL_GUID, Runtime,
                              UNINITIALIZED_GUID, id_type, spawn_main)


def demo_lids(say):
    """§3: creating remote tasks without blocking round-trips."""
    rt = Runtime(num_nodes=4, net_latency=5.0)

    def worker(paramv, depv, api):
        return NULL_GUID

    def main_edt(paramv, depv, api):
        tmpl = api.edt_template_create(worker, 0, 1)
        # LID creation returns immediately — a *future* for the GUID
        task, _ = api.edt_create(tmpl, depv=[UNINITIALIZED_GUID],
                                 props=EDT_PROP_LID, placement=2)
        say(f"  created remote task, id type = {id_type(task).value}")
        # API calls on the LID are deferred and patched on resolution
        api.add_dependence(NULL_GUID, task, 0, DbMode.NULL)
        # ocrGetGuid is the one blocking call, if you really need the GUID
        guid = api.get_guid(task)
        say(f"  resolved to {guid}")
        return NULL_GUID

    spawn_main(rt, main_edt)
    stats = rt.run()
    say(f"  stats: msgs={stats.messages_sent} "
        f"blocking={stats.blocking_roundtrips} "
        f"deferred={stats.messages_deferred}")


def demo_partitioning(say, device):
    """§6: disjoint EW partitions execute in parallel."""
    rt = Runtime(copy_backend="cuda", copy_device=device)
    out = {}

    def work(paramv, depv, api):
        depv[0].ptr.view(np.uint32)[:] *= np.uint32(paramv[0])
        api.db_destroy(depv[0].guid)
        return NULL_GUID

    def finish(paramv, depv, api):
        out["sum"] = int(depv[0].ptr.view(np.uint32).sum())
        return NULL_GUID

    def main_edt(paramv, depv, api):
        db, ptr = api.db_create(1024 * 4)
        ptr.view(np.uint32)[:] = 1
        api.db_release(db)
        parts = api.db_partition(db, [(0, 2048), (2048, 2048)])
        tmpl = api.edt_template_create(work, 1, 1)
        api.edt_create(tmpl, paramv=[2], depv=[parts[0]],
                       dep_modes=[DbMode.EW], duration=10)
        api.edt_create(tmpl, paramv=[6], depv=[parts[1]],
                       dep_modes=[DbMode.EW], duration=10)
        # the parent is quiescent until both partitions are destroyed
        ftmpl = api.edt_template_create(finish, 0, 1)
        api.edt_create(ftmpl, depv=[db], dep_modes=[DbMode.RO])
        return NULL_GUID

    spawn_main(rt, main_edt)
    stats = rt.run()
    say(f"  sum = {out['sum']} (512·2 + 512·6 = 4096); "
        f"makespan = {stats.makespan:.0f} (parallel, not 2×10 serial)")


def demo_fileio(say):
    """§5: file-mapped chunks with dirty write-back."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.u32")
        np.arange(64, dtype=np.uint32).tofile(path)
        rt = Runtime()

        def double(paramv, depv, api):
            depv[0].ptr.view(np.uint32)[:] *= 2
            api.db_destroy(depv[0].guid)         # EW ⇒ write-back on destroy
            return NULL_GUID

        def main_edt(paramv, depv, api):
            f, desc = api.file_open(path, "rb+")

            def after_open(pv, dv, api2):        # runs once the file is open
                size = api2.file_get_size(dv[0].ptr)
                fg = api2.file_get_guid(dv[0].ptr)
                tmpl2 = api2.edt_template_create(double, 0, 1)
                for off in (0, size // 2):       # two disjoint chunks
                    chunk = api2.file_get_chunk(fg, off, size // 2)
                    api2.edt_create(tmpl2, depv=[chunk],
                                    dep_modes=[DbMode.EW])
                api2.file_release(fg)
                return NULL_GUID

            tmpl = api.edt_template_create(after_open, 0, 1)
            api.edt_create(tmpl, depv=[desc])
            return NULL_GUID

        spawn_main(rt, main_edt)
        rt.run()
        data = np.fromfile(path, np.uint32)
    ok = np.array_equal(data, np.arange(64, dtype=np.uint32) * 2)
    say(f"  file doubled in 2 parallel chunks: ok={ok}")


def demo_zero_copy(say, device):
    """§6.3: ocrDbCopy with DB_COPY_PARTITION is zero-copy."""
    rt = Runtime(copy_backend="cuda", copy_device=device)

    def main_edt(paramv, depv, api):
        block, ptr = api.db_create(1024)
        ptr[:] = 7
        api.db_release(block)
        view, _ = api.db_create(512, props=DB_PROP_NO_ACQUIRE)
        api.db_copy(view, 0, block, 256, 512, DB_COPY_PARTITION)
        return NULL_GUID

    spawn_main(rt, main_edt)
    stats = rt.run()
    say(f"  zero-copy bytes={stats.bytes_zero_copy} "
        f"copied={stats.bytes_copied}")


def main(device: str = "cuda") -> list:
    """Run the four demos, printing each line; returns the lines."""
    lines = []

    def say(line):
        print(line)
        lines.append(line)

    say("§3 local identifiers:")
    demo_lids(say)
    say("§6 partitioning:")
    demo_partitioning(say, device)
    say("§5 file IO:")
    demo_fileio(say)
    say("§6.3 zero-copy:")
    demo_zero_copy(say, device)
    say("done.")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the §6.3 fused copies run (default cuda)")
    main(ap.parse_args().device)
