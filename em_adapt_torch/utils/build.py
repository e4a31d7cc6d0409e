"""Build the port's CUDA sources and its host library at first use and
load them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/em_adapt_torch/`` in the checkout, named by a
hash of the source and the flags: an unchanged source is not rebuilt.
``defines`` (macro names, passed as ``-D``) build a variant of a source
into a library of its own, whose file name carries them; with none the
library is the production one. A failed build raises. No
``--use_fast_math``: flush-to-zero would change subnormal values, and
the E-step's thresholds must equal ``np.partition``'s bits.

:func:`build_host` compiles a C++ source of the repository's ``native/``
(the permutohedral lattice of the host CRF) with ``g++`` and the flags of
``native/Makefile`` into the same directory, named by a hash of the
source, the flags and the CPU that ``-march=native`` resolves to (with
PyTorch's OpenMP runtime where the compiler has none); nothing is written
under ``native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "em_adapt_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

NATIVE = Path(__file__).resolve().parents[2] / "native"
#: native/Makefile's CXXFLAGS and REQFLAGS, warnings aside.
CXX_FLAGS = ("-O3", "-std=c++17", "-march=native", "-fPIC", "-fopenmp", "-shared")

_lock = threading.Lock()
_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
#: nvcc's report (registers, shared memory, spills) of each build, by
#: (source name, defines); kept beside the library and read back from
#: there when the library was built by an earlier process.
build_logs: dict[tuple[str, tuple[str, ...]], str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    tag = "".join(f"+{d}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{digest}.so"


def build(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` with ``-D`` for each of ``defines``
    unless it is built already; the library's path."""
    defines = tuple(defines)
    target = _target(name, defines)
    log = target.with_suffix(".log")
    if target.exists() and log.exists():
        build_logs.setdefault((name, defines), log.read_text())
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_logs[(name, defines)] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {name}.cu {list(defines)} failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, target)
    return target


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` with ``defines``
    (built if needed)."""
    key = (name, tuple(defines))
    with _lock:
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(str(build(*key)))
        return _loaded[key]


def sass_count(library: Path, opcode: str) -> int:
    """How many SASS instructions of ``opcode`` (e.g. "HMMA") the library's
    device code holds, as ``cuobjdump -sass`` of the toolkit lists them."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(tool), "-sass", str(library)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {library.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}")
    return sum(1 for line in proc.stdout.splitlines()
               if any(w == opcode or w.startswith(opcode + ".")
                      for w in line.replace(";", " ").split()))


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found: the permutohedral lattice needs a C++ compiler")
    return found


def _native_target(cxx: str) -> str:
    """What ``-march=native`` means on this host, so that a library built
    for another CPU is never loaded here."""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc.stdout


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _torch_openmp() -> Path | None:
    """The OpenMP runtime (libgomp) that the PyTorch wheel ships, if any."""
    spec = importlib.util.find_spec("torch")
    if spec is None or not spec.submodule_search_locations:
        return None
    root = Path(next(iter(spec.submodule_search_locations)))
    found = sorted(root.glob("lib/libgomp*.so*")) + sorted(
        root.parent.glob("torch.libs/libgomp*.so*"))
    return found[0] if found else None


def build_host(name: str) -> Path:
    """Compile ``native/<name>.cpp`` with ``g++`` and :data:`CXX_FLAGS`
    unless it is built already; the library's path. Where the compiler has
    no OpenMP runtime of its own (no ``libgomp.spec``, so that g++ cannot
    link ``-fopenmp``), the source is compiled with ``-fopenmp`` all the
    same and linked against PyTorch's libgomp, so the library is never
    quietly serial. Concurrent builds (several test workers) each write a
    file of their own and rename it into place. A failed build raises."""
    cxx = _cxx()
    src = NATIVE / f"{name}.cpp"
    key = src.read_bytes() + " ".join(CXX_FLAGS).encode() + _native_target(cxx).encode()
    target = BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = _run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)])
    gomp = _torch_openmp() if "libgomp.spec" in proc.stdout else None
    if proc.returncode != 0 and gomp is not None:
        obj = tmp.with_suffix(".o")
        proc = _run([cxx, *(f for f in CXX_FLAGS if f != "-shared"), "-c", "-o", str(obj),
                     str(src)])
        if proc.returncode == 0:
            proc = _run([cxx, "-shared", "-o", str(tmp), str(obj), str(gomp),
                         f"-Wl,-rpath,{gomp.parent}"])
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ build of native/{name}.cpp failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, target)
    return target
