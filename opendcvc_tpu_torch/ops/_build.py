"""Build and load the port's hand-written kernels.

Each `csrc/*.cu` is compiled at first use by its own `nvcc` (all started
together) into a shared library with a plain C interface, under
OPENDCVC_TPU_BUILD_DIR when it is set (read at each build, as the JAX
package's `native/build.py` reads it), else `opendcvc_tpu_torch/_build/`,
and loaded with ctypes.  A library is named
by a hash of the sources, so an edited source builds anew.  A build or load
failure raises: there is no fallback.

`load_host_shim` compiles `csrc/lane_rans_host.cpp` (the kernels' per-lane
arithmetic from `lane_rans_step.cuh`) with g++ for the CPU tests.
`load_host_rans` compiles `csrc/rans.cpp`, the host entropy coder of the
host-EC path, with g++ the same way; it too raises on failure.
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
#: the build directory when OPENDCVC_TPU_BUILD_DIR is unset
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: the host C++ compiler of the two g++ builds
CXX = "g++"

_LOCK = threading.Lock()
_LIBS = {}
_HOST_RANS = {}
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


def _build_dir():
    """OPENDCVC_TPU_BUILD_DIR, else BUILD_DIR; created if missing."""
    d = os.environ.get("OPENDCVC_TPU_BUILD_DIR") or BUILD_DIR
    os.makedirs(d, exist_ok=True)
    return d


def _headers():
    return glob.glob(os.path.join(CSRC, "*.cuh"))


def build_kernels():
    """Compile every csrc/*.cu not yet built; returns {name: .so path}."""
    build_dir = _build_dir()
    headers = _headers()
    outs, procs = {}, {}
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        name = os.path.splitext(os.path.basename(src))[0]
        out = os.path.join(build_dir,
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


def _gxx_build(name, srcs, flags):
    """Compile `srcs` with CXX into <build dir>/lib<name>_<hash>.so unless
    it is there; each process writes its own temporary name and renames
    it, so concurrent builds never share a file.  Returns the path."""
    out = os.path.join(_build_dir(), f"lib{name}_{_tag(srcs)}.so")
    if not os.path.exists(out):
        tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
        cmd = [CXX] + flags + [srcs[0], "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{name} build failed: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{name} build failed:\n{res.stderr}")
        os.replace(tmp, out)
    return out


def load_host_rans():
    """g++ build (once) of csrc/rans.cpp, the host rANS coder; returns the
    loaded CDLL with its C API's signatures set.  Raises on failure."""
    with _LOCK:
        if not _HOST_RANS:
            path = _gxx_build("rans_host",
                              [os.path.join(CSRC, "rans.cpp")],
                              ["-O3", "-std=c++17", "-shared", "-fPIC",
                               "-pthread"])
            lib = ctypes.CDLL(path)
            for fn, (restype, argtypes) in _HOST_RANS_SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _HOST_RANS["lib"] = lib
        return _HOST_RANS["lib"]


_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_HOST_RANS_SIGNATURES = {
    "rve_enc_new": (_P, [_I]),
    "rve_enc_free": (None, [_P]),
    # handle, cdfs, n_cdf, row_len, sizes, offsets, build_lut
    "rve_enc_add_cdf": (_I, [_P, _I32P, _I, _I, _I32P, _I32P, _I]),
    "rve_enc_set_two": (None, [_P, _I]),
    "rve_enc_reset": (None, [_P]),
    # handle, packed symbols, n, group
    "rve_enc_y": (None, [_P, ctypes.POINTER(ctypes.c_int16), _I, _I]),
    # handle, symbols, n, group, start_offset, per_channel, interleaved,
    # idx_base
    "rve_enc_z": (None, [_P, ctypes.POINTER(ctypes.c_int8)] + [_I] * 6),
    "rve_enc_flush": (None, [_P]),
    "rve_enc_stream_size": (_I, [_P]),
    "rve_enc_get_stream": (None, [_P, _U8P]),
    "rve_dec_new": (_P, [_I]),
    "rve_dec_free": (None, [_P]),
    "rve_dec_add_cdf": (_I, [_P, _I32P, _I, _I, _I32P, _I32P, _I]),
    "rve_dec_set_two": (None, [_P, _I]),
    "rve_dec_set_stream": (None, [_P, _U8P, _I]),
    # handle, indexes, n, group
    "rve_dec_y": (None, [_P, _U8P, _I, _I]),
    # handle, total, group, start_offset, per_channel, interleaved,
    # idx_base
    "rve_dec_z": (None, [_P] + [_I] * 6),
    "rve_dec_size": (_I, [_P]),
    "rve_dec_get": (None, [_P, ctypes.POINTER(ctypes.c_int8)]),
    "rve_dec_check_end": (_I, [_P]),
}


def load_host_shim():
    """g++ build of csrc/lane_rans_host.cpp; returns the loaded CDLL."""
    src = os.path.join(CSRC, "lane_rans_host.cpp")
    out = _gxx_build("lane_rans_host", [src] + _headers(),
                     ["-O2", "-std=c++17", "-fno-strict-aliasing", "-shared",
                      "-fPIC", "-I", CSRC])
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
