"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every ``.cu`` file is compiled for ``sm_90a`` by its own ``nvcc`` process (all
started together), then linked into one shared library with a plain C
interface that is loaded with ``ctypes``. The build runs at first use, from
the sources in the checkout only, into ``build/`` at the repository root; the
library name carries a hash of the sources and flags, so an edit rebuilds.

Each C entry point takes device pointers and a ``cudaStream_t`` as
``c_void_p``, launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
A wrapper binds its entry point (``fn``) once, at its first launch, and
keeps it in a module global. ``with_plain_grad`` gives a forward-only
kernel the gradient of its plain version, recomputed in the backward pass;
when no gradient is wanted it calls the kernel alone, so a call under
``torch.inference_mode()`` or ``torch.no_grad()`` pays for no autograd node.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
_fns: dict = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libus_medsam2_kernels_{h.hexdigest()[:16]}.so"


def build(log=None) -> Path:
    """Compile and link the kernels if the library for these sources is
    missing; returns its path. ``log`` receives the compiler's messages
    (register and shared-memory use from ``-Xptxas -v``)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
            objs.append(obj)
        failed = []
        for src, p in procs:
            msg, _ = p.communicate()
            if log is not None:
                log(f"[nvcc {src.name}]\n{msg}")
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{msg}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so_tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.usm_error_string.argtypes = [ctypes.c_int]
        lib.usm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fn(name: str, argtypes: list):
    """The C entry point ``name`` with its argument types set."""
    f = _fns.get(name)
    if f is None:
        f = getattr(load(), name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = load().usm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


# every kernel wrapper imported so far, by name: its ``launches`` adds one
# where it launches its kernel, and nowhere else. Each wrapper's module
# registers it (``counted``) when it is imported.
COUNTED: dict = {}


def counted(wrapper):
    """Register ``wrapper`` in ``COUNTED`` with its launch count at 0."""
    wrapper.launches = 0
    COUNTED[wrapper.__name__] = wrapper
    return wrapper


def zero_launches() -> None:
    """Set every registered wrapper's launch count to 0."""
    for w in COUNTED.values():
        w.launches = 0


def launch_counts() -> dict:
    """{wrapper name: launches} of every wrapper registered so far."""
    return {name: w.launches for name, w in COUNTED.items()}


def stream_ptr(t) -> int:
    """The current ``cudaStream_t`` of t's device, without making a
    ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# An H100 SM (sm_90): what a kernel's blocks an SM are computed from
SMS = 132
SMEM_PER_SM = 233472  # bytes, of which 1 KB a block is the runtime's
SMEM_PER_BLOCK = 232448
REGISTERS_PER_SM = 65536
THREADS_PER_SM = 2048
BLOCKS_PER_SM_MAX = 32
# Thread-block clusters of C blocks the card runs at once
# (cudaOccupancyMaxActiveClusters) by (C, blocks an SM): the H100's SMs sit in
# GPCs of uneven size, so this is below 132 / C. chip_smoke.py holds it
# against the card at every plan of the qkv window-attention and CXBlock
# kernels.
CLUSTERS_AT_ONCE = {(2, 1): 66, (3, 1): 39, (4, 1): 30, (5, 1): 22, (6, 1): 17, (7, 1): 15, (8, 1): 15}


def blocks_per_sm(registers: int, smem: int, threads: int) -> int:
    """How many blocks of a kernel one SM holds, from its registers a thread
    (``-Xptxas -v``; allocated 256 a warp), dynamic shared memory a block
    and threads a block: the model of
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` that the plans of the
    kernels size their grids by (``chip_smoke.py`` holds it against the card)."""
    warps = -(-threads // 32)
    by_smem = SMEM_PER_SM // (smem + 1024)
    regs_warp = -(-registers * 32 // 256) * 256
    by_regs = REGISTERS_PER_SM // regs_warp // warps
    return max(0, min(by_smem, by_regs, THREADS_PER_SM // (32 * warps), BLOCKS_PER_SM_MAX))


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float


_TENSOR = object()  # marks the argument slots that hold saved tensors


class _Recompute(torch.autograd.Function):
    """Forward: the kernel. Backward: the vjp of the plain version,
    recomputed from the saved inputs (the JAX custom_vjp's XLA recompute).
    The backward launches no kernel."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.slots = [_TENSOR if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*[a for a in args if torch.is_tensor(a)])
        return kernel(*args)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        args, wrt = list(ctx.slots), []
        saved = iter(ctx.saved_tensors)
        for i, slot in enumerate(ctx.slots):
            if slot is _TENSOR:
                args[i] = next(saved).detach().requires_grad_(need[i])
                if need[i]:
                    wrt.append(args[i])
        with torch.enable_grad():
            out = ctx.plain(*args)
        # allow_unused: an input the plain version ignores for these arguments
        # (LN parameters without ln_inside) gets no gradient, as in autograd
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True) if wrt else ())
        return (None, None, *[next(grads) if need[i] else None for i in range(len(args))])


def with_plain_grad(kernel, plain, *args):
    """``kernel(*args)`` whose gradient is that of ``plain(*args)``; the
    kernel alone, with no autograd node, when grad mode is off or no tensor
    argument requires a gradient."""
    if torch.is_grad_enabled():
        for a in args:  # a loop, not any() over a generator: this runs on every call
            if isinstance(a, torch.Tensor) and a.requires_grad:
                return _Recompute.apply(kernel, plain, *args)
    return kernel(*args)
