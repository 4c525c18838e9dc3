"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each ``csrc/<name>.cu`` compiles on first use with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library under
``build/repro_torch_kernels/`` at the root of the checkout; an installed
copy of the package, with no checkout around it, builds under
``$REPRO_TORCH_BUILD_DIR`` or else the user's cache directory. The library
name carries a hash of the source and of the headers it may include
(``csrc/*.cuh``, ``csrc/*.h``), so an edited kernel or header never loads
a stale build, and a finished build is reused by later processes. ``build_all()``
starts one ``nvcc`` per source at once; ``load(name)`` returns the loaded
``ctypes.CDLL``.

The wrappers share three helpers: ``entry`` binds a C entry point (every
one returns the launch's ``cudaError`` code), ``raise_on`` turns that code
into an error, and ``check`` validates a tensor argument.

Every wrapper has a fake form for a fake tensor (``is_fake``:
``FakeTensorMode``'s shapes, dtypes and device, no data), which the dry
run (``launch``) traces: the wrapper's own checks, its ``cost(...)``
charged while a count is open, outputs of the kernel's shapes and dtypes
on the input's device, and no launch (``.launches`` does not move). It
computes nothing, so it is no fallback: a real CUDA tensor never takes
it. A fake tensor on the meta device stands for a card there
(``on_card``): a CPU-only build cannot run autograd on fake CUDA
tensors.

Nothing here runs at import: the CPU test suite imports every module on a
machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[3]      # <root>/src/repro_torch
    if (root / "pyproject.toml").exists() and (root / "src").is_dir():
        return root / "build" / "repro_torch_kernels"
    if os.environ.get("REPRO_TORCH_BUILD_DIR"):
        return Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
             else shutil.which("nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    of every header in ``csrc/`` (in sorted order) and of the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; None when an up-to-date build exists."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, lib


def _finish(name: str, started) -> None:
    proc, tmp, lib = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, lib)         # atomic: a concurrent builder sees all or none


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel (one nvcc each); returns
    {name: library path}. Raises if any build fails."""
    with _lock:
        started = {n: _start(n) for n in sources()}
        errors = []
        for name, st in started.items():
            if st is None:
                continue
            try:
                _finish(name, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: str(_lib_path(n)) for n in started}


def build_log(name: str) -> str:
    """nvcc's output (with ptxas register / shared-memory use) of the last
    build of ``name`` in this checkout; empty if it was never built here."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
        return lib


def entry(lib: str, fn: str, argtypes: Sequence):
    """The C entry point ``fn`` of ``csrc/<lib>.cu`` (built and loaded on
    first use) with its argument types set; it returns a cudaError code."""
    f = _entries.get((lib, fn))
    if f is None:
        f = getattr(load(lib), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _entries[(lib, fn)] = f
    return f


def raise_on(rc: int, name: str) -> None:
    """Raise unless the launch's cudaError code ``rc`` is 0."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor: its wrapper takes the fake form
    (module docstring)."""
    return isinstance(t, FakeTensor)


def on_card(t) -> bool:
    """Whether a kernel takes ``t`` as a card's tensor: a CUDA tensor, or
    a fake tensor on the meta device (the dry run's card on a build
    without CUDA)."""
    return t.is_cuda or (t.device.type == "meta" and isinstance(t, FakeTensor))


def address(t):
    """Where ``t``'s data starts, for the wrappers' aliasing checks:
    ``data_ptr()``, or for a fake tensor (no data) its storage and byte
    offset, which compare as two real tensors' addresses would."""
    if isinstance(t, FakeTensor):
        return (id(t.untyped_storage()), t.storage_offset() * t.element_size())
    return t.data_ptr()


def check(name, t, device, shape=None, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` CUDA tensor on
    ``device`` (of ``shape`` when given; ``on_card``)."""
    if not isinstance(t, torch.Tensor) or not on_card(t) or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
