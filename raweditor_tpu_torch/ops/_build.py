"""Build and load the port's CUDA kernels.

Every ``raweditor_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface,
``build/raweditor_tpu_torch/libkernels.so`` under the repository root,
and loaded with ``ctypes``. The build runs at first use, one ``nvcc``
per source started together, and is cached by a hash of the sources and
flags. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "raweditor_tpu_torch"
LIB_NAME = "libkernels.so"

# -fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions are; no --use_fast_math, so powf/sqrtf are IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(p, p.communicate()[0]) for p in procs]
    for cmd, (p, out) in zip(cmds, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return [out for _, out in outs]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the cached library matches the
    sources; returns the library path. ``verbose`` adds ``-Xptxas -v``
    and prints the compiler's report."""
    srcs = _sources()
    digest = _digest(srcs)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if (not verbose and lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    objs = [BUILD_DIR / (s.stem + f".{os.getpid()}.o") for s in srcs]
    outs = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(o)]
                     for s, o in zip(srcs, objs)])
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
               str(tmp)]])
    os.replace(tmp, lib)
    stamp.write_text(digest)
    for o in objs:
        o.unlink()
    if verbose:
        print("".join(outs))
    return lib


def _signatures():
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_longlong
    tables = ctypes.c_char_p  # the packed CfaTables bytes on the host
    return {
        # (mosaics, scal, out0, out1, n, h, w, py, px, output, [demosaic,]
        #  quant, stream); quant: the transfer's QuantTable on the device
        "rtt_develop_launch": [ptr] * 4 + [i32] * 7 + [ptr, ptr],
        "rtt_develop_grad_launch": [ptr] * 4 + [i32] * 6 + [ptr, ptr],
        # The generic-CFA kernels: (mosaics, scal, out0, out1, n, h, w,
        #  output, [demosaic,] packed tables, quant, stream)
        "rtt_develop_cfa_launch": [ptr] * 4 + [i32] * 5 + [tables, ptr, ptr],
        "rtt_develop_grad_cfa_launch": [ptr] * 4 + [i32] * 4 + [tables, ptr,
                                                                 ptr],
        # The LinearRaw kernel: (frames, scal, out0, out1, n, h, w, output,
        #  quant, stream)
        "rtt_linear_launch": [ptr] * 4 + [i32] * 4 + [ptr, ptr],
        # (packed tables): 1 where the grad launcher takes its period-6
        #  march, else 0 (not an error code)
        "rtt_develop_grad_cfa_period6": [tables],
        # (quant, values, out, n, stream): the table quantiser's check
        "rtt_quant_sweep_launch": [ptr, ptr, ptr, i32, ptr],
        # (words, table, out0, out1, n, h, w, mixer_on, grading_on,
        #  stencils, output, cy, cx, icy, icx, stream)
        "rtt_extras_launch": [ptr] * 4 + [i32] * 7 + [f32] * 4 + [ptr],
        # The resize: (words, itab, ftab, out0, out1, out2, n, h, w, out_h,
        #  out_w, transposed, tm, tc, nstrips, strip_max, ring, output,
        #  smem_bytes, stream); the tables from fused_resize.kernel_plan
        "rtt_resize_launch": [ptr] * 6 + [i32] * 13 + [ptr],
        # (srcs, dsts, fmts: host arrays of the slots' source pointers,
        #  slot pointers and formats, nslots, samples a slot, stream)
        "rtt_unpack_slots_launch": [ptr] * 3 + [i32, i64, ptr],
    }


#: The C interface's argument types; each returns an int, the launchers a
#: CUDA error code.
SIGNATURES = _signatures()


def declare(lib, names=SIGNATURES):
    """Declares the C signatures of the launchers ``names`` on ``lib``."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def load():
    """The loaded kernel library (built first if needed), with the C
    signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = declare(ctypes.CDLL(str(build())))
            lib.rtt_error_string.argtypes = [ctypes.c_int]
            lib.rtt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.rtt_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
