"""The C++ NPZ reader (``native/npz_reader.cpp``) through ctypes, and a
threaded prefetcher built on it.

Counterpart of the JAX package's ``training/native_npz.py``. ctypes calls
release the GIL, so the C++ inflate runs in parallel from a plain thread
pool while the step runs. The reader is off unless ``UVMS2_NATIVE_NPZ=1``
(``core/switches.py``, the JAX package's name); then numpy reads. Set, the
library is built at first use from the source in the checkout
(``c++ -O3 -shared -fPIC ... -lz`` into ``build/``, named by a hash of the
source and flags), and a build that fails raises: the reader never gives way
to numpy while it is asked for, nor does an array of a dtype it cannot read.
``PrefetchingNPZLoader`` works with either reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from us_video_medsam2_tpu_torch.core.switches import native_npz_enabled

SOURCE = Path(__file__).resolve().parents[1] / "native" / "npz_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib = None

_DTYPES = {
    ("f", 4): np.float32, ("f", 8): np.float64, ("f", 2): np.float16,
    ("i", 1): np.int8, ("i", 2): np.int16, ("i", 4): np.int32, ("i", 8): np.int64,
    ("u", 1): np.uint8, ("u", 2): np.uint16, ("u", 4): np.uint32, ("u", 8): np.uint64,
    ("b", 1): np.bool_,
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libnpz_reader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the reader if the library for this source is missing; raises
    with the compiler's message when it cannot be built."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("UVMS2_NATIVE_NPZ=1 but no C++ compiler (c++ / g++) is on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")  # builders racing each rename a whole file
    res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lz"], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"UVMS2_NATIVE_NPZ=1 but the native NPZ reader does not build:\n{res.stderr}")
    tmp.replace(out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded reader, or None when the switch is off."""
    global _lib
    if not native_npz_enabled():
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.npz_list.restype = ctypes.c_int
            lib.npz_array_info.restype = ctypes.c_int
            lib.npz_read_array.restype = ctypes.c_int64
            _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def load_npz(path: str, names=None) -> Dict[str, np.ndarray]:
    """The arrays ``names`` (all by default) of an ``.npz``: through the C++
    reader when the switch is on, else numpy."""
    lib = get_lib()
    if lib is None:
        with np.load(path) as data:
            return {k: data[k] for k in (names or data.files)}
    bpath = path.encode()
    if names is None:
        buf = ctypes.create_string_buffer(1 << 16)
        rc = lib.npz_list(bpath, buf, ctypes.c_int64(len(buf)))
        if rc != 0:
            raise IOError(f"npz_list({path}) failed: {rc}")
        names = json.loads(buf.value.decode())
    out = {}
    for name in names:
        dt, isz, nd = ctypes.c_char(), ctypes.c_int(), ctypes.c_int()
        shape = (ctypes.c_int64 * 8)()
        rc = lib.npz_array_info(bpath, name.encode(), ctypes.byref(dt), ctypes.byref(isz), ctypes.byref(nd),
                                shape)
        if rc != 0:
            raise IOError(f"npz_array_info({path}, {name}) failed: {rc}")
        dtype = _DTYPES.get((dt.value.decode(), isz.value))
        if dtype is None:
            raise IOError(f"{path}: {name} has dtype {dt.value.decode()}{isz.value}, which the native reader "
                          "does not read (unset UVMS2_NATIVE_NPZ to read it with numpy)")
        arr = np.empty(tuple(shape[i] for i in range(nd.value)), dtype)
        n = lib.npz_read_array(bpath, name.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               ctypes.c_int64(arr.nbytes))
        if n != arr.nbytes:
            raise IOError(f"npz_read_array({path}, {name}) returned {n}")
        out[name] = arr
    return out


class PrefetchingNPZLoader:
    """Read-ahead NPZ loading: the next ``ahead`` videos are read on a thread
    pool while the current batch trains."""

    def __init__(self, num_workers: int = 4, ahead: int = 8):
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.ahead = ahead
        self._pending: Dict[str, Future] = {}

    def schedule(self, path: str, names=None):
        if path not in self._pending and len(self._pending) < self.ahead:
            self._pending[path] = self.pool.submit(load_npz, path, names)

    def get(self, path: str, names=None) -> Dict[str, np.ndarray]:
        fut = self._pending.pop(path, None)
        if fut is not None:
            return fut.result()
        return load_npz(path, names)
