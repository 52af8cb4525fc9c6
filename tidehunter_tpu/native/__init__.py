"""Native host kernels (C, loaded via ctypes).

Irregular host control flow that the reference ran in C (the chaining DP
with data-dependent early exits, reference src/tandem_chain.c; seeding;
the partition walk's small alignments; graph-POA) stays native here too.
The shared library is built from the committed sources on first use, with
the system compiler, into ``.native_build/`` at the checkout root (git
ignores it).  The file name carries a hash of the sources, the compiler
and its flags, so a changed source or flag builds a new library and a
stale one is never loaded.  Portable flags only: the library must load on
any x86-64 or arm64 host that runs the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "chainx.c"), os.path.join(_DIR, "seedx.c"),
         os.path.join(_DIR, "alignx.c"), os.path.join(_DIR, "poax.c")]
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                          ".native_build")
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    cc = os.environ.get("CC", "cc")
    h = hashlib.sha256(" ".join([cc] + _FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libchainx-{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CC", "cc")] + _FLAGS + ["-o", tmp] + _SRCS
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        print(f"[native] build failed: {exc}", file=sys.stderr)
        return False
    os.replace(tmp, path)     # atomic: concurrent builders never see half
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = lib_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as exc:
        print(f"[native] load failed: {exc}", file=sys.stderr)
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.th_chain.restype = ctypes.c_int64
    lib.th_chain.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                             i64p, i64p, i64p]
    lib.th_chain_post.restype = ctypes.c_int64
    lib.th_chain_post.argtypes = [i64p, i64p, i64p, i64p, ctypes.c_int64,
                                  i64p, i64p, i64p]
    lib.th_seed.restype = ctypes.c_int64
    lib.th_seed.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                            i64p, i64p]
    lib.th_global_tleft_batch.restype = None
    lib.th_global_tleft_batch.argtypes = [u8p, i64p, i64p, u8p, i64p, i64p,
                                          i64p, ctypes.c_int64, i64p, i64p]
    lib.th_global_tleft.restype = ctypes.c_int64
    lib.th_global_tleft.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64]
    lib.th_walk_right.restype = ctypes.c_int64
    lib.th_walk_right.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_int64]
    lib.th_poa_msa.restype = ctypes.c_int64
    lib.th_poa_msa.argtypes = [u8p, i64p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               u8p, i64p, ctypes.c_int64]
    _lib = lib
    return _lib
