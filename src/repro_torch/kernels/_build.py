"""Build and load the CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` file compiles with its own ``nvcc`` process (all
started together) for ``sm_90a``; the objects link into one shared
library with a plain C interface, loaded through ``ctypes``.  The build
runs at first use, into ``build/`` at the repository root, under a name
keyed on the hash of the sources and flags — an edited source rebuilds,
an unchanged one loads the library already there.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: (name, argtypes); each returns a cudaError_t
_ENTRIES = {
    # q, k, v, out, lse (or null), B, H, KH, Sq, Sk, hd, q_offset, causal,
    # window, dtype, stream
    "repro_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    # q, k, v, dout, lse, delta, dq, B, H, KH, Sq, Sk, hd, q_offset,
    # causal, window, dtype, stream
    "repro_flash_bwd_dq": (_P,) * 7 + (_I,) * 10 + (_P,),
    # q, k, v, dout, lse, delta, dk, dv, then as above
    "repro_flash_bwd_dkv": (_P,) * 8 + (_I,) * 10 + (_P,),
    # q, k, v, dout, lse, delta, dq_acc (fp32), dk, dv, then as above
    "repro_flash_bwd_fused": (_P,) * 9 + (_I,) * 10 + (_P,),
    # q, k_cache, v_cache, cur_len, out, B, KH, G, S, hd, window, dtype,
    # stream
    "repro_flash_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_kernels_{_digest()}.so"


def log_path() -> Path:
    """The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills per kernel) from the build of the current sources."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    raises with the compiler's output if any step fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        failed = False
        for src, proc in zip(_sources(), procs):
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            failed |= proc.returncode != 0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        so_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *map(str, objs), "-o", str(so_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        Path(tmp, "log").write_text("\n".join(logs))
        # rename last: a concurrent build sees a whole library or none
        os.replace(Path(tmp, "log"), log_path())
        os.replace(so_tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = load().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
