"""Build and load the port's hand-written kernels.

Each `csrc/*.cu` is compiled at first use by its own `nvcc` (all started
together) into a shared library with a plain C interface, under
`opendcvc_tpu_torch/_build/`, and loaded with ctypes.  A library is named
by a hash of the sources, so an edited source builds anew.  A build or load
failure raises: there is no fallback.

`load_host_shim` compiles `csrc/lane_rans_host.cpp` (the kernels' per-lane
arithmetic from `lane_rans_step.cuh`) with g++ for the CPU tests.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS = {}
#: compiler output of the last kernel build (ptxas register and shared
#: memory report per kernel), by source name
BUILD_LOG = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lane_rans": {
        # packed, enc_table, staging, lens, states, K, L, nr, mw, stream
        "lr_encode_launch": [_P] * 5 + [_I] * 4 + [_P],
        # data, rows, table, state_in, ptr_in, syms, state_out, ptr_out,
        # K, L, nr, mw, stream
        "lr_decode_launch": [_P] * 8 + [_I] * 4 + [_P],
    },
}


def _tag(paths):
    h = hashlib.sha256()
    for p in sorted(paths):
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _headers():
    return glob.glob(os.path.join(CSRC, "*.cuh"))


def build_kernels():
    """Compile every csrc/*.cu not yet built; returns {name: .so path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    headers = _headers()
    outs, procs = {}, {}
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        name = os.path.splitext(os.path.basename(src))[0]
        out = os.path.join(BUILD_DIR,
                           f"lib{name}_{_tag([src] + headers)}.so")
        outs[name] = out
        if not os.path.exists(out):
            tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
            cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, src]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return outs


def load_kernels():
    """Build (once) and load the kernel libraries; returns {name: CDLL}."""
    with _LOCK:
        if not _LIBS:
            libs = {}
            for name, path in build_kernels().items():
                lib = ctypes.CDLL(path)
                for fn, argtypes in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                libs[name] = lib
            _LIBS.update(libs)
        return dict(_LIBS)


def load_host_shim():
    """g++ build of csrc/lane_rans_host.cpp; returns the loaded CDLL."""
    src = os.path.join(CSRC, "lane_rans_host.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR,
                       f"liblane_rans_host_{_tag([src] + _headers())}.so")
    if not os.path.exists(out):
        tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
        cmd = ["g++", "-O2", "-std=c++17", "-fno-strict-aliasing", "-shared",
               "-fPIC", "-I", CSRC, src, "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"host shim build failed:\n{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    lib.lr_encode_host.argtypes = [_P] * 5 + [_I] * 4
    lib.lr_encode_host.restype = None
    # d, ml, mh, x, n, q, r
    lib.lr_divmod_host.argtypes = [_P] * 4 + [ctypes.c_int64] + [_P] * 2
    lib.lr_divmod_host.restype = None
    lib.lr_decode_host.argtypes = [_P] * 8 + [_I] * 4
    lib.lr_decode_host.restype = None
    # dtab, nr, sym, start, next
    lib.lr_lookup_host.argtypes = [_P, _I, _P, _P, _P]
    lib.lr_lookup_host.restype = None
    return lib
