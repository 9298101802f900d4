"""Time K7 and K8 (the fused multi-range partition copies) of whichever
``repro_torch`` is first on ``sys.path``, so that two trees can be
compared on one card in one run.

    PYTHONPATH=<tree>/src python scripts/torch_copy_ab.py LABEL OUT
        [--variants]

Appends one JSON line to OUT: LABEL, the package's path and, as
[median, min, max] ms over 20 calls (50 for K7) behind
``chip_smoke._time_stats``'s 64 MB L2 flush, on ``chip_smoke.py``'s
sets (K7: 64 ragged ranges of 4 MiB buffers; K8: 64 ragged ranges of
256 MiB buffers):

* ``call``: CUDA events around the bare launch, its tables (a parent
  tree) or range descriptor (this tree) built beforehand — the kernel
  rows' ``ms``;
* ``device``: the same behind a ~0.5 ms device spin, the device work
  alone;
* ``wrapper``: events around ``partition_copy.multi_partition_copy``,
  the call a user makes (checks, tables or descriptor, launch), and
  ``wrapper_host_us``, the host µs it takes (``chip_smoke._host_us``);
* ``floor`` (K7): device-only time of the bare launch on a one-row,
  one-range set;
* ``many``: a 256-range set (past the by-value descriptor's 240 ranges)
  device-only and through the wrapper;
* ``host_split`` (a tree with the range descriptor): host µs of each
  step of K7's and K8's wrapper call — the buffer and range checks, the
  descriptor, the stream lookup and the C launch — and of ``ops``'s
  byte-range checks, each alone;
* ``kernel_step``: the 64-partition fused copy's kernel step as
  ``chip_smoke._fused_copy_split`` replays it
  (``ops.multi_partition_copy_bytes_`` on buffers already on the card,
  host clock with a sync on both sides), 4 MiB and 256 MiB, over 10
  calls.

The timers, inputs and sets are chip_smoke's own, imported after the
tree's ``repro_torch``.  To compare a change with its parent, unpack the
parent's ``src`` into a directory that git ignores and run parent,
change, change, parent in one command; each tree builds its kernels into
its own ``build/``.  Needs a CUDA card.

With ``--variants`` (this tree only; needs nvcc) the line also holds
K7's ablations on the 4 MiB set, each held bit-exact against the plain
version first: tile rows 64, 128 and 256 (the wrapper's ``block_rows``);
a persistent grid (``PERSISTENT``, a text patch of
``csrc/partition_copy.cu`` built into ``build/copy_variants/``: blocks
walk entries b, b + grid, ...) at 1, 2 and 4 blocks an SM for each tile
size; and the 64-range descriptor forced onto the card.  A patch that
no longer matches the source raises.
"""
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import repro_torch  # noqa: F401  (the tree under test, before chip_smoke)
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import partition_copy as pc
from repro_torch.kernels.autotune import plan_copy_chunk

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

# K7 as a persistent grid, patched into csrc/partition_copy.cu before the
# end of its namespace (by-value descriptors only)
PERSISTENT = r"""
__global__ void __launch_bounds__(NT)
multi_copy_tiles_persistent_kernel(uint4* __restrict__ dst,
                                   const uint4* __restrict__ src,
                                   const __grid_constant__ ParamRanges r,
                                   int total) {
  for (int e = blockIdx.x; e < total; e += gridDim.x) {
    const Entry t = find_entry(r, e);
    copy_rows(dst + (int64_t)t.dst * ROW_VECS,
              src + (int64_t)t.src * ROW_VECS, t.rows);
  }
}
"""
PERSISTENT_ENTRY = r"""
extern "C" int repro_multi_partition_copy_tiles_persistent(
    void* dst, const void* src, const void* cols_host, int n, int total,
    int entry_rows, int grid, void* stream) {
  using namespace repro;
  if (total <= 0) return cudaSuccess;
  if (grid <= 0) return cudaErrorInvalidValue;
  ParamRanges p;
  const cudaError_t err =
      param_ranges(p, static_cast<const int*>(cols_host), n, entry_rows);
  if (err != cudaSuccess) return err;
  multi_copy_tiles_persistent_kernel<<<grid, NT, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(dst), static_cast<const uint4*>(src), p, total);
  return cudaGetLastError();
}
"""


def _stats(fn, reps, flush, spin=False):
    st = cs._time_stats(fn, reps, flush, spin=spin)
    return [st["median"], st["min"], st["max"]]


def _prepared(ranges, entry_rows, staged):
    """The bare launch of K7, or of K8 (``staged``), with its tables or
    descriptor of ``entry_rows``-row entries built: ``launch(dst, src)``."""
    if hasattr(pc, "descriptor"):
        desc = pc.descriptor(ranges, entry_rows, "cuda")
        fn = pc.launch_staged if staged else pc.launch_tiles
        return lambda dst, src: fn(dst, src, desc)
    tabs = pc.tables(ranges, entry_rows, "cuda")
    if staged:
        return lambda dst, src: pc.launch_staged(dst, src, tabs, entry_rows)
    return lambda dst, src: pc.launch_tiles(dst, src, tabs)


def _kernel_rows(name, nbytes, seeds, reps, flush):
    dst, src = cs._rand_rows(nbytes, seeds[0]), cs._rand_rows(nbytes,
                                                              seeds[1])
    ranges = cs._rows_of(cs._ragged_set(nbytes, 64))
    many = cs._rows_of(cs._ragged_set(nbytes, 256))
    entry_rows = (pc.BLOCK_ROWS if name == "k7"
                  else plan_copy_chunk(sum(r for _, _, r in ranges)))
    want = pc.multi_partition_copy_plain(dst.clone(), src, ranges)
    staged = name == "k8"
    launch = _prepared(ranges, entry_rows, staged)
    got = launch(dst.clone(), src)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version")
    del got, want
    wrapper = lambda: pc.multi_partition_copy(dst, src, ranges)  # noqa: E731
    row = {"call": _stats(lambda: launch(dst, src), reps, flush),
           "device": _stats(lambda: launch(dst, src), reps, flush, spin=True),
           "wrapper": _stats(wrapper, reps, flush),
           "wrapper_host_us": cs._host_us(wrapper),
           "entry_rows": entry_rows}
    if name == "k7":
        one = _prepared(((0, 0, 1),), entry_rows, staged)
        row["floor"] = _stats(lambda: one(dst, src), reps, flush, spin=True)
    many_launch = _prepared(many, plan_copy_chunk(
        sum(r for _, _, r in many)) if staged else entry_rows, staged)
    row["many"] = {
        "ranges": len(many),
        "device": _stats(lambda: many_launch(dst, src), reps, flush,
                         spin=True),
        "wrapper": _stats(lambda: pc.multi_partition_copy(dst, src, many),
                          reps, flush)}
    if hasattr(pc, "descriptor"):
        row["host_split"] = _host_split(name, dst, src, ranges, entry_rows)
    return row, (dst, src, ranges)


def _host_split(name, dst, src, ranges, entry_rows):
    """Host µs of each step of a wrapper call, each timed alone."""
    what = "multi_partition_copy"
    rows = pc._check(dst, src, ranges, what)
    desc = pc.descriptor(rows, entry_rows, dst.device)
    lib, stream = pc._cuda_args(dst, what)
    args = (dst.data_ptr(), src.data_ptr(), *pc._desc_args(desc), desc.total)
    if name == "k7":
        launch = lambda: lib.repro_multi_partition_copy_tiles(  # noqa: E731
            *args, entry_rows, stream)
    else:
        grid = min(desc.total, pc._sm_count(dst.device))
        launch = lambda: lib.repro_multi_partition_copy_staged(  # noqa: E731
            *args, entry_rows, grid, stream)
    byte_ranges = [(d * pc.LANES, s * pc.LANES, n * pc.LANES)
                   for d, s, n in ranges]
    nbytes = dst.numel()
    return {"checks": cs._host_us(lambda: pc._check(dst, src, ranges, what)),
            "descriptor": cs._host_us(
                lambda: pc.descriptor(rows, entry_rows, dst.device)),
            "stream": cs._host_us(lambda: pc._cuda_args(dst, what)),
            "launch": cs._host_us(launch),
            "ops_byte_checks": cs._host_us(
                lambda: kernel_ops._row_ranges(byte_ranges, nbytes, nbytes))}


def _kernel_step(size, reps=10):
    """Host-clock ms of the fused copy's kernel step on card buffers."""
    ranges = cs._ragged_set(size, 64)
    dst = torch.zeros(size, dtype=torch.uint8, device="cuda")
    src = cs._rand_rows(size, 900).reshape(-1)
    ms = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel_ops.multi_partition_copy_bytes_(dst, src, ranges)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    ms = ms[2:]
    return [statistics.median(ms), min(ms), max(ms)]


def _build_persistent():
    end = "}  // namespace\n}  // namespace repro\n"
    text = (_build.CSRC / "partition_copy.cu").read_text()
    if text.count(end) != 1:
        raise RuntimeError("the persistent variant's patch no longer matches")
    out_dir = _build.BUILD_DIR / "copy_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "persistent.cu"
    path.write_text(text.replace(end, PERSISTENT + end + PERSISTENT_ENTRY))
    lib_path = out_dir / "libpersistent.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), "-o", str(lib_path), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout[-3000:]}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.repro_multi_partition_copy_tiles_persistent
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, proc.stdout


def _variants(dst, src, ranges, flush):
    out = {"tile_rows": {}, "persistent": {}}
    want = pc.multi_partition_copy_plain(dst.clone(), src, ranges)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    persistent, log = _build_persistent()
    out["persistent_ptxas"] = [ln for ln in log.splitlines()
                               if "persistent" in ln or "Used" in ln][-4:]
    for rows in (64, 128, 256):
        desc = pc.descriptor(ranges, rows, "cuda")
        launch = lambda d, desc=desc: pc.launch_tiles(d, src, desc)  # noqa
        if not torch.equal(launch(dst.clone()), want):
            raise AssertionError(f"K7 at {rows} tile rows disagrees")
        out["tile_rows"][rows] = {
            "entries": desc.total,
            "call": _stats(lambda: launch(dst), 50, flush),
            "device": _stats(lambda: launch(dst), 50, flush, spin=True)}
        for per_sm in (1, 2, 4):
            grid = min(desc.total, sms * per_sm)

            def call(d, desc=desc, grid=grid):
                err = persistent(
                    d.data_ptr(), src.data_ptr(), desc.cols.ctypes.data,
                    desc.cols.shape[1], desc.total, rows, grid,
                    torch.cuda.current_stream().cuda_stream)
                _build.check(err, "persistent K7")
                return d
            if not torch.equal(call(dst.clone()), want):
                raise AssertionError(f"persistent K7 {rows} x {per_sm}/SM "
                                     f"disagrees")
            out["persistent"][f"{rows} rows, {per_sm}/SM"] = {
                "grid": grid,
                "device": _stats(lambda: call(dst), 50, flush, spin=True)}
    forced = pc.descriptor(ranges, pc.BLOCK_ROWS, "cuda", route="device")
    if not torch.equal(pc.launch_tiles(dst.clone(), src, forced), want):
        raise AssertionError("K7 on the forced device route disagrees")
    out["forced_device_route"] = {
        "call": _stats(lambda: pc.launch_tiles(dst, src, forced), 50, flush),
        "device": _stats(lambda: pc.launch_tiles(dst, src, forced), 50,
                         flush, spin=True)}
    return out


def main() -> int:
    label, out = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        print("torch_copy_ab: no CUDA device", file=sys.stderr)
        return 1
    _build.load()
    flush = torch.empty(64 * cs.MIB, dtype=torch.uint8, device="cuda")
    res = {"label": label, "src": pc.__file__}
    res["k8"], bufs = _kernel_rows("k8", 256 * cs.MIB, (400, 401), 20, flush)
    del bufs
    torch.cuda.empty_cache()
    res["k7"], (dst, src, ranges) = _kernel_rows("k7", 4 * cs.MIB,
                                                 (402, 403), 50, flush)
    res["kernel_step"] = {"4mib": _kernel_step(4 * cs.MIB),
                          "256mib": _kernel_step(256 * cs.MIB)}
    if "--variants" in sys.argv[3:]:
        res["variants"] = _variants(dst, src, ranges, flush)
    line = json.dumps(res)
    print(line)
    with open(out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
