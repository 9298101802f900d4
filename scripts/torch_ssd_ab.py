"""Time K9 (the Mamba2 SSD scan) and K6 (the single-range partition copy)
of whichever ``repro_torch`` is first on ``sys.path``, so that two trees
can be compared on one card in one run.

    PYTHONPATH=<tree>/src python scripts/torch_ssd_ab.py LABEL OUT
        [--variants]

Appends one JSON line to OUT: LABEL, the package's path, and for each of
``chip_smoke.py``'s three timed K9 shapes (mamba2 4 x 4096, zamba2
1 x 3000 with N 64, mamba2 1 x 16384; bf16) the call's [median, min,
max] ms over 10 calls under both of ``chip_smoke._time_stats``'s timers
(``events``, every kernel row's timer, and ``device``, the device work
alone), the largest |difference| of y from the plain version and the
route taken; where the tree has the tensor-core route's stages
(``chunk_states_tc``, ``chunk_scan_tc``), K9s and K9y alone
(device-only).  Then K6 on chip_smoke's 128 MiB range beside one
``Tensor.copy_`` of it, 20 calls each under both timers, in turn.  The
timer, the inputs and the shapes are chip_smoke's own, imported after
the tree's ``repro_torch``, so chip_smoke runs on that tree.  To compare
a change with its parent, unpack the parent's ``src`` into a directory
that git ignores and run parent, change, change, parent in one command;
each tree builds its kernels into its own ``build/``.  Needs a CUDA card.

With ``--variants`` (this tree only; needs nvcc) the line also holds an
ablation of the tensor-core route: builds of ``csrc/ssd_scan.cu`` with
one part taken out or one design choice undone (``VARIANTS``; the mma of
K9s or of K9y replaced by an empty statement that keeps its operands
live, either kernel's loads dropped, K9s with a ring of three chunks,
K9y's row tiles in warp order, K9y's exact exps below the diagonal),
each timed as K9s and K9y alone (device-only) at mamba2's 4 x 4096 and
1 x 16384; K9y at 1, 2, 4 and 8 heads a block (``tc_group`` forced) at
zamba2's 1 x 3000, mamba2's 4 x 4096 and 1 x 2048; and the K6 designs
that lost to the tile kernel (``K6_VARIANTS``: persistent rings of
``cp.async.bulk`` copies through shared memory, one with an L2
evict-first policy, and the tile kernel with streaming hints), added to
``csrc/partition_copy.cu`` as a text patch and built beside it: each
held bit-exact against ``partition_copy_plain`` on a single tile, a
range that is not a whole number of stages and the 128 MiB range, then
timed there beside the tile kernel and ``copy_``, behind chip_smoke's
zeroing L2 flush and behind one that reads (clean lines).  A variant
whose text patch no longer matches the source raises.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import repro_torch  # noqa: F401  (the tree under test, before chip_smoke)
from repro_torch.kernels import _build
from repro_torch.kernels import partition_copy as pc
from repro_torch.kernels import ssd_scan as ssd

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

K9_TIMED = {  # B, H, S, P, N, chunk: phase_k9's timed cases
    "mamba2_4x4096": (4, 64, 4096, 64, 128, 128),
    "zamba2_1x3000": (1, 64, 3000, 64, 64, 128),
    "mamba2_1x16384": (1, 64, 16384, 64, 128, 128),
}


# stand-ins for the tensor-core instructions, keeping their operands and
# accumulators live so that the code around them stays as built
FAKE = """
__device__ __forceinline__ void fake_mma(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("" : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}
"""
K9S = ("// K9s.  Block", "inline size_t states_tc_smem")
K9Y = ("// K9y.  Block", "inline size_t scan_tc_smem")
# name: list of (region or None, old, new) patches of csrc/ssd_scan.cu
VARIANTS = {
    "as_built": [],
    "k9s_no_mma": [(K9S, "mma_bf16(", "fake_mma(")],
    "k9y_no_mma": [(K9Y, "mma_bf16(", "fake_mma(")],
    "k9s_no_loads": [(None, "    load(c + TC_RING - 1);\n",
                      "    cp_async_commit();\n")],
    "k9y_no_head_loads": [(None, "    if (g + 1 < G) load_head(g + 1, "
                           "buf ^ 1);", "")],
    "k9s_ring3": [(None, "constexpr int TC_RING = 2;",
                   "constexpr int TC_RING = 3;"),
                  (None, "__launch_bounds__(TC_NT, 2) ssd_states_tc_kernel",
                   "__launch_bounds__(TC_NT, 1) ssd_states_tc_kernel")],
    "k9y_tiles_in_warp_order": [(None, "  const int mt = warp < 4 ? warp : "
                                 "11 - warp;", "  const int mt = warp;")],
    "k9y_exact_exps": [(None, "      if (jp < mt) {", "      if (false) {")],
}


# K6's losing designs, patched into csrc/partition_copy.cu before the end
# of its namespace; mode 0 the bulk-copy ring, 3 the same with an L2
# evict-first policy, 2 the tile kernel with evict-first loads and
# streaming stores
K6_KERNELS = r"""
constexpr int TILE_ROWS = 256;
constexpr int MAX_STAGES = 8;

__global__ void __launch_bounds__(NT)
partition_copy_stream_kernel(uint4* __restrict__ dst,
                             const uint4* __restrict__ src, int d_row,
                             int s_row, int rows) {
  const int r0 = blockIdx.x * TILE_ROWS;
  const int nvec = min(TILE_ROWS, rows - r0) * ROW_VECS;
  dst += ((int64_t)d_row + r0) * ROW_VECS;
  src += ((int64_t)s_row + r0) * ROW_VECS;
  for (int base = 0; base < nvec; base += NT * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = base + j * NT + threadIdx.x;
      if (i < nvec) v[j] = __ldcs(src + i);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = base + j * NT + threadIdx.x;
      if (i < nvec) __stcs(dst + i, v[j]);
    }
  }
}

// `nbytes` from src to dst in pieces of `stage` bytes through `stages`
// (>= 2) shared-memory slots; block b takes pieces b, b + grid, ...  Lane
// 0 issues every copy; a slot is refilled once the store that read it
// has read it (wait_group.read).
template <bool EVICT_FIRST>
__global__ void __launch_bounds__(32)
partition_copy_bulk_kernel(char* __restrict__ dst,
                           const char* __restrict__ src, int64_t nbytes,
                           int stage, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  if (threadIdx.x != 0) return;
  uint64_t policy = 0;
  if (EVICT_FIRST)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
  const int64_t npieces = (nbytes + stage - 1) / stage;
  const int64_t mine =
      npieces > blockIdx.x ? (npieces - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto piece_of = [&](int64_t i) { return blockIdx.x + i * gridDim.x; };
  auto bytes_of = [&](int64_t piece) {
    return (uint32_t)min((int64_t)stage, nbytes - piece * stage);
  };
  auto load = [&](int64_t i) {
    const int64_t piece = piece_of(i);
    const int s = (int)(i % stages);
    if (!EVICT_FIRST) {
      bulk_load(ring + (size_t)s * stage, src + piece * stage,
                bytes_of(piece), &bars[s]);
      return;
    }
    const uint32_t b = smem_u32(&bars[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(bytes_of(piece)) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
        :: "r"(smem_u32(ring + (size_t)s * stage)), "l"(src + piece * stage),
           "r"(bytes_of(piece)), "r"(b), "l"(policy) : "memory");
  };
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(&bars[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int64_t i = 0; i < min((int64_t)stages, mine); ++i) load(i);
  for (int64_t i = 0; i < mine; ++i) {
    const int s = (int)(i % stages);
    mbar_wait(&bars[s], (uint32_t)((i / stages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int64_t piece = piece_of(i);
    if (EVICT_FIRST)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
          "[%0], [%1], %2, %3;\n"
          :: "l"(dst + piece * stage), "r"(smem_u32(ring + (size_t)s * stage)),
             "r"(bytes_of(piece)), "l"(policy) : "memory");
    else
      bulk_store(dst + piece * stage, ring + (size_t)s * stage,
                 bytes_of(piece));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (i >= 1 && i - 1 + stages < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + stages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
"""
K6_ENTRY = r"""
extern "C" int repro_partition_copy_variant(void* dst, const void* src,
                                            int d_row, int s_row, int rows,
                                            int mode, int stage, int stages,
                                            int grid, void* stream) {
  using namespace repro;
  if (rows <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    partition_copy_stream_kernel<<<(rows + TILE_ROWS - 1) / TILE_ROWS, NT, 0,
                                   st>>>(
        static_cast<uint4*>(dst), static_cast<const uint4*>(src), d_row,
        s_row, rows);
    return cudaGetLastError();
  }
  if ((mode != 0 && mode != 3) || stage <= 0 || stage % 16 || stages < 2 ||
      stages > MAX_STAGES || grid <= 0)
    return cudaErrorInvalidValue;
  auto kern = mode == 0 ? partition_copy_bulk_kernel<false>
                        : partition_copy_bulk_kernel<true>;
  const size_t smem = (size_t)stage * stages;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t row = (int64_t)ROW_VECS * 16;
  kern<<<grid, 32, smem, st>>>(static_cast<char*>(dst) + d_row * row,
                               static_cast<const char*>(src) + s_row * row,
                               rows * row, stage, stages);
  return cudaGetLastError();
}
"""
# name: (mode, stage bytes, stages, blocks an SM)
K6_VARIANTS = {
    "bulk 32K x4, 1/SM": (0, 32768, 4, 1),
    "bulk 16K x4, 2/SM": (0, 16384, 4, 2),
    "bulk 64K x3, 1/SM": (0, 65536, 3, 1),
    "bulk 16K x8, 1/SM": (0, 16384, 8, 1),
    "bulk 8K x4, 4/SM": (0, 8192, 4, 4),
    "bulk 32K x4, 1/SM, evict-first": (3, 32768, 4, 1),
    "tile, streaming hints": (2, 0, 0, 0),
}
K6_CHECKS = [  # rows of dst, of src, dst row, src row, rows
    (1024, 1024, 256, 512, 256),          # one tile
    (4096, 4096, 100, 3000, 1000),        # not a whole number of stages
    (2 ** 21, 2 ** 21, 2 ** 18, 3 * 2 ** 18, 2 ** 20),   # 128 MiB
]


def _patch(text, region, old, new):
    lo, hi = (text.index(region[0]), text.index(region[1])) if region \
        else (0, len(text))
    if old not in text[lo:hi]:
        raise RuntimeError(f"a variant's patch no longer matches: {old!r}")
    return text[:lo] + text[lo:hi].replace(old, new) + text[hi:]


def _build_variants():
    """({name: ctypes library} of csrc/ssd_scan.cu patched per variant,
    the library of csrc/partition_copy.cu with K6's designs patched in),
    compiled in parallel into build/ssd_variants/."""
    text = (_build.CSRC / "ssd_scan.cu").read_text().replace(
        "namespace {\n", "namespace {\n" + FAKE, 1)
    sources = {}
    for name, patches in VARIANTS.items():
        src = text
        for patch in patches:
            src = _patch(src, *patch)
        sources[name] = src
    end = "}  // namespace\n}  // namespace repro\n"
    copy_text = (_build.CSRC / "partition_copy.cu").read_text()
    sources["k6_designs"] = _patch(copy_text, None, end,
                                   K6_KERNELS + end + K6_ENTRY)
    out_dir = _build.BUILD_DIR / "ssd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(out_dir / f"lib{name}.so"),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    copy_lib = libs.pop("k6_designs")
    copy_lib.repro_partition_copy_variant.argtypes = \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    copy_lib.repro_partition_copy_variant.restype = ctypes.c_int
    for lib in libs.values():
        lib.repro_ssd_scan_tc.argtypes = list(
            _build._ENTRIES["repro_ssd_scan_tc"])
        lib.repro_ssd_scan_tc.restype = ctypes.c_int
    return libs, copy_lib


def _k6_design(lib, design, dst, src, d0, s0, rows):
    """Launch one of K6's losing designs (``K6_VARIANTS``) on checked
    buffers."""
    mode, stage, stages, per_sm = design
    grid = 0
    if mode != 2:
        sms = torch.cuda.get_device_properties(
            dst.device).multi_processor_count
        grid = min(-(-rows * pc.LANES // stage), sms * per_sm)
    err = lib.repro_partition_copy_variant(
        dst.data_ptr(), src.data_ptr(), d0, s0, rows, mode, stage, stages,
        grid, torch.cuda.current_stream(dst.device).cuda_stream)
    _build.check(err, "K6 design")


def _k6_designs(lib, flush):
    """K6's designs held bit-exact on ``K6_CHECKS``, then each timed on
    the 128 MiB range beside the tile kernel and ``copy_``, behind the
    zeroing flush and behind a reading one."""
    for nd, ns, d0, s0, rows in K6_CHECKS:
        dst, src = cs._rand_rows(nd * pc.LANES, 402), \
            cs._rand_rows(ns * pc.LANES, 403)
        want = pc.partition_copy_plain(dst.clone(), src, d0, s0, rows)
        for name, design in K6_VARIANTS.items():
            got = dst.clone()
            _k6_design(lib, design, got, src, d0, s0, rows)
            if not torch.equal(got, want):
                raise AssertionError(f"K6 {name} disagrees with its plain "
                                     f"version at {(nd, ns, d0, s0, rows)}")
        del dst, src, want, got
    dst, src = cs._rand_rows(256 * cs.MIB, 400), cs._rand_rows(256 * cs.MIB,
                                                               401)
    k6 = (32 * cs.MIB // pc.LANES, 96 * cs.MIB // pc.LANES,
          128 * cs.MIB // pc.LANES)
    d0, s0, rows = k6
    calls = {name: (lambda design=design: _k6_design(lib, design, dst, src,
                                                     *k6))
             for name, design in K6_VARIANTS.items()}
    calls["tile (K6)"] = lambda: pc.partition_copy(dst, src, *k6)
    calls["copy_"] = lambda: dst[d0:d0 + rows].copy_(src[s0:s0 + rows])
    out, read = {}, _ReadFlush()
    for name, fn in calls.items():
        out[name] = {"zero_flush": _stats(fn, 20, flush),
                     "read_flush": _stats(fn, 20, read)}
    return out


class _ReadFlush:
    """An L2 flush by a read of 64 MB (it leaves clean lines), in the
    place of chip_smoke's zeroing write."""

    def __init__(self):
        self.buf = torch.ones(16 * 2 ** 20, device="cuda")

    def zero_(self):
        self.buf.sum()


def _variants(flush):
    out = {}
    libs, copy_lib = _build_variants()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (b, h, s, p, n) in (
            ("mamba2_4x4096", (4, 64, 4096, 64, 128)),
            ("mamba2_1x16384", (1, 64, 16384, 64, 128))):
        args = cs._ssd_inputs(b, h, s, p, n, torch.bfloat16, 9)
        x, dt, A, B, C = args
        nc = -(-s // 128)
        y = torch.empty_like(x)
        st = torch.empty((b, h, p, n), device="cuda")
        scr = torch.empty((b, h, nc, 2, p, n), dtype=torch.bfloat16,
                          device="cuda")
        strides = ssd._strides(x, y, dt, B, C)
        ptrs = [t.data_ptr() for t in (x, dt, A, B, C, y, st, scr)]
        for name, lib in libs.items():
            def call(stages):
                err = lib.repro_ssd_scan_tc(
                    *ptrs, b, h, s, p, n, 128, ssd.tc_group(b, h, nc, sms),
                    *strides, stages,
                    torch.cuda.current_stream().cuda_stream)
                _build.check(err, f"variant {name}")
            out.setdefault(name, {})[label] = {
                "k9s_device": _stats(lambda: call(1), 10, flush, spin=True),
                "k9y_device": _stats(lambda: call(2), 10, flush, spin=True)}
        del args, x, dt, A, B, C, y, st, scr
        torch.cuda.empty_cache()
    groups, tc_group = {}, ssd.tc_group
    for label, (b, h, s, p, n) in (
            ("zamba2_1x3000", (1, 64, 3000, 64, 64)),
            ("mamba2_4x4096", (4, 64, 4096, 64, 128)),
            ("mamba2_1x2048", (1, 64, 2048, 64, 128))):
        args = cs._ssd_inputs(b, h, s, p, n, torch.bfloat16, 10)
        scratch, _ = ssd.chunk_states_tc(*args)
        row = {"tc_group": tc_group(b, h, -(-s // 128), sms)}
        try:
            for g in (1, 2, 4, 8):
                ssd.tc_group = lambda *_, g=g: g
                row[f"G{g}"] = _stats(
                    lambda: ssd.chunk_scan_tc(*args, scratch), 10, flush,
                    spin=True)
        finally:
            ssd.tc_group = tc_group
        groups[label] = row
        del args, scratch
        torch.cuda.empty_cache()
    return {"variants": out, "k9y_groups": groups,
            "k6_designs": _k6_designs(copy_lib, flush)}


def _stats(fn, reps, flush, spin=False):
    st = cs._time_stats(fn, reps, flush, spin=spin)
    return [st["median"], st["min"], st["max"]]


def main() -> int:
    label, out = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        print("torch_ssd_ab: no CUDA device", file=sys.stderr)
        return 1
    _build.load()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    res = {"label": label, "src": ssd.__file__}
    staged = hasattr(ssd, "chunk_states_tc")
    for i, (name, (b, h, s, p, n, chunk)) in enumerate(K9_TIMED.items()):
        args = cs._ssd_inputs(b, h, s, p, n, torch.bfloat16, 700 + i)
        call = lambda: ssd.ssd_scan(*args, chunk=chunk)  # noqa: E731
        y, _ = call()
        yw, _ = ssd.ssd_scan_plain(*args, chunk=chunk)
        row = {"events": _stats(call, 10, flush),
               "device": _stats(call, 10, flush, spin=True),
               "max_abs_err": (y.float() - yw.float()).abs().max().item(),
               "route": getattr(ssd.ssd_scan, "last_route", None)}
        del y, yw
        if staged and row["route"] == "tc":
            scratch, _ = ssd.chunk_states_tc(*args, chunk=chunk)
            row["k9s_device"] = _stats(
                lambda: ssd.chunk_states_tc(*args, chunk=chunk), 10, flush,
                spin=True)
            row["k9y_device"] = _stats(
                lambda: ssd.chunk_scan_tc(*args, scratch, chunk=chunk), 10,
                flush, spin=True)
            del scratch
        res[f"k9_{name}"] = row
        del args
        torch.cuda.empty_cache()
    dst, src = cs._rand_rows(256 * cs.MIB, 400), cs._rand_rows(256 * cs.MIB,
                                                               401)
    d0, s0, rows = (32 * cs.MIB // pc.LANES, 96 * cs.MIB // pc.LANES,
                    128 * cs.MIB // pc.LANES)
    k6 = lambda: pc.partition_copy(dst, src, d0, s0, rows)  # noqa: E731
    lib = lambda: dst[d0:d0 + rows].copy_(src[s0:s0 + rows])  # noqa: E731
    for key, fn in (("k6", k6), ("copy_", lib), ("k6_again", k6),
                    ("copy_again", lib)):
        res[key] = {"events": _stats(fn, 20, flush),
                    "device": _stats(fn, 20, flush, spin=True)}
    del dst, src
    torch.cuda.empty_cache()
    if "--variants" in sys.argv[3:]:
        res.update(_variants(flush))
    line = json.dumps(res)
    print(line)
    with open(out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
