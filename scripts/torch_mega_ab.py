"""Time the bf16 K4f (with lse) and K4b of the ``repro_torch`` beside this
script against K1-lse and K3, and, with ``--variants``, builds of the
same mega source with one design choice undone, all in one process.

    PYTHONPATH=src python scripts/torch_mega_ab.py OUT [--variants]

Shapes: B x 256 tokens with H=15, KH=5, hd 64, bf16, causal, at B = 64
(chip_smoke's short training shape: 320 blocks), 52 (260 blocks: one
wave of two K4b blocks an SM) and 32 (its short-serve prefill).  Times
are chip_smoke's events timer, [median, min, max] ms of 20 cold-L2 calls
(10 for the backwards).  Each variant is compiled from
``csrc/flash_attention_mega.cu`` with a text patch, into ``build/``:

* ``no_snake``: warp w takes slices w, w + 4, ...; K4b's groups take kv
  tiles in plain order;
* ``one_group``: K4b at hd 64 as one four-warp block (its shared memory
  sum given here: two blocks an SM);
* ``p_once``: P and dS rounded once to bf16 (the lo products dropped),
  the pairs' cost (its results are not the kernels');
* ``phase1_only`` / ``phase2_only``: K4b's dk/dv or dq pass alone.

Appends one JSON line to OUT and prints it.  Needs a CUDA card and nvcc.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

MEGA = _build.CSRC / "flash_attention_mega.cu"
BATCHES = (64, 52, 32)


def _one_group_smem(sk):
    """K4b's bytes at hd 64 with one four-warp group (the source's
    BwdTc with GROUPS = 1)."""
    return 2 * (-(-sk // 64) * 64) * 64 * 2 + 33_792


# name: (list of (old, new) source patches, K4b shared memory or None)
VARIANTS = {
    "no_snake": ([("return i * n + ((i & 1) ? n - 1 - w : w);",
                   "return i * n + w;")], None),
    "one_group": ([("static constexpr int GROUPS = HD == 64 ? 2 : 1;",
                    "static constexpr int GROUPS = 1;")], _one_group_smem),
    "p_once": ([('#include "common.cuh"', '#include "common.cuh"\n'
                 "#define mma_pair(c0, c1, hi, lo, b) do { "
                 "mma_bf16(c0, hi, b[0], b[1]); "
                 "mma_bf16(c1, hi, b[2], b[3]); } while (0)")], None),
    "phase1_only": ([("  // ---- phase 2: dq.",
                      "  return;\n  // ---- phase 2: dq.")], None),
    "phase2_only": ([("  for (int m = 0; m < n_m; ++m) {\n    const int j",
                      "  for (int m = 0; m < 0; ++m) {\n    const int j")],
                    None),
}


def _build_variants(names):
    """{name: ctypes library} of the mega source patched per variant."""
    text = MEGA.read_text()
    out_dir = _build.BUILD_DIR / "mega_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name][0]:
            if old not in src:
                raise RuntimeError(f"variant {name}: its patch no longer "
                                   "matches the source")
            src = src.replace(old, new)
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
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn in ("repro_flash_mega_fwd", "repro_flash_mega_bwd"):
            getattr(lib, fn).argtypes = list(_build._ENTRIES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _calls(lib, smem_bwd, tensors):
    """K4f-lse and K4b of one library on these inputs, as the wrappers
    launch them (fresh outputs)."""
    q, k, v, do, _out, lse, delta = tensors
    o, l_ = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sk = k.shape[2]
    rf, sf = fa._mega_block("mega_ab", False, sk, 64, q.dtype)
    rb, sb = fa._mega_block("mega_ab", True, sk, 64, q.dtype)
    if smem_bwd is not None:
        sb = smem_bwd(sk)
    dims, st = fa._dims(q, k, 0, True, 0), fa._stream(q)

    def fwd():
        _build.check(lib.repro_flash_mega_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            l_.data_ptr(), *dims, rf, sf, st), "K4f variant")

    def bwd():
        _build.check(lib.repro_flash_mega_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *dims, rb, sb, st), "K4b variant")
    return fwd, bwd


def main() -> int:
    out = sys.argv[1]
    if not torch.cuda.is_available():
        print("torch_mega_ab: no CUDA device", file=sys.stderr)
        return 1
    _build.load()
    names = list(VARIANTS) if "--variants" in sys.argv[2:] else []
    libs = _build_variants(names)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    res = {"src": fa.__file__, "device": torch.cuda.get_device_name(0)}

    def stats(fn, reps):
        st = cs._time_stats(fn, reps, flush)
        return [st["median"], st["min"], st["max"]]

    for b in BATCHES:
        t = cs._k4_inputs(b, 256, 11)
        q, k, v, do, _out, lse, delta = t
        args = (q, k, v, do, lse, delta)
        row = {"k4f_lse": stats(lambda: fa.flash_attention_mega_fwd(
                   q, k, v, with_lse=True), 20),
               "k4b": stats(lambda: fa.flash_attention_mega_bwd(*args), 10),
               "k1_lse": stats(lambda: fa.flash_attention_fwd(q, k, v), 20),
               "k3": stats(lambda: fa.flash_attention_bwd_fused(*args), 10)}
        for name, lib in libs.items():
            fwd, bwd = _calls(lib, VARIANTS[name][1], t)
            row[name] = {"k4f_lse": stats(fwd, 20), "k4b": stats(bwd, 10)}
        res[f"B{b}"] = row
        del t, q, k, v, do, _out, lse, delta, args
        torch.cuda.empty_cache()
    print(json.dumps(res))
    with open(out, "a") as f:
        f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
