"""Build and load the CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared
library with a plain C interface (no PyTorch headers, so one build takes
seconds) and loads through ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>-<hash>.so

The library name carries a hash of the sources, so an edited kernel is
never served from a stale build.  ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them together.  The ptxas register
and shared-memory report of each build is kept beside its library
(``lib<name>-<hash>.ptxas.txt``), so :func:`ptxas_report` returns it
whether this process built the library or found it built.

Every C entry point takes its pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``), its sizes as ``int`` and its scalars as
``float``, launches on the
given stream, allocates nothing, and returns ``cudaGetLastError()``;
:func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("binary_attention", "bitpack", "bitplane_conv", "bn_sign_pack",
           "conv_bn_sign", "dense_stack", "mma_probe", "xnor_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels of repro_torch cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _ptxas_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".ptxas.txt")


def _start(nvcc: str, name: str):
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    _ptxas_path(name).write_text(log)
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Build every named kernel library that is not built yet, with one
    ``nvcc`` per source running in parallel."""
    nvcc = find_nvcc()
    started = {n: _start(nvcc, n) for n in names}
    errors = []
    for n, st in started.items():
        try:
            _finish(n, st)
        except RuntimeError as e:       # wait for every nvcc before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_report(names=SOURCES) -> dict[str, str]:
    """The kept ptxas log of each built library, by kernel name."""
    return {n: _ptxas_path(n).read_text() for n in names
            if _ptxas_path(n).is_file()}


def cuda_device(t, name: str):
    """The device of ``t``, a launch operand; raises unless it is a CUDA
    tensor.  The plain versions serve CPU tensors (``kernels/ops.py``)."""
    if not t.is_cuda:
        raise ValueError(f"{name} is on {t.device}: the CUDA kernels take "
                         f"CUDA tensors only (kernels.ops routes CPU tensors "
                         f"to the plain versions)")
    return t.device


def load(name: str, entries: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``entries`` maps each
    C function to its argument types (``'p'`` pointer/stream, ``'i'``
    int, ``'f'`` float)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        types = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        for fn, sig in entries.items():
            f = getattr(lib, fn)
            f.argtypes = [types[c] for c in sig]
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def require(t, name: str, dtype, shape: tuple, device) -> int:
    """Check one operand of a launch; returns its data pointer.

    The kernels take contiguous tensors of one dtype and shape on the
    launch's device and nothing else."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def stream_of(t) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {err}")
