"""Build and bind the port's CUDA kernels, at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its
own by `nvcc` into a shared library, which `ctypes` loads (no PyTorch
headers, so a build takes seconds). Libraries go into `_build_out/`
beside this file, named by a hash of the source and of every `csrc/`
header it includes, so a stale build is never loaded. Nothing is built
when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build_out"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point and argument types of each kernel library
SIGNATURES = {
    "egress_rank": ("egress_rank_launch",
                    [_I, _I, _I] + [_P] * 10 + [_P] * 12 + [_P]),
    "route_place": ("route_place_launch",
                    [_I, _I, _I, _I] + [_P] * 3 + [_P] * 2 + [_P] * 4
                    + [_P] * 6 + [_P]),
    "egress_gate": ("egress_gate_launch",
                    [_I, _I, _I] + [_P] * 6 + [_P] * 7 + [_P]),
    "route_scatter": ("route_scatter_launch",
                      [_I, _I, _I, _I] + [_P] * 3 + [_P] * 2 + [_P] * 4
                      + [_P] * 6 + [_P]),
    "router_drain": ("router_drain_launch",
                     [_I, _I, _I, _I] + [_P] * 5 + [_P] * 13 + [_P] * 13
                     + [_P] * 5 + [_P]),
    # ten ints, then an array of the world's tensor pointers and its length
    "flow_window": ("flow_window_launch", [_I] * 10 + [_P, _I] + [_P]),
}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}
# the compiler's output of each kernel built in this process (ptxas'
# resource report when built with verbose_ptxas)
LOGS: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _sources(name: str) -> list[Path]:
    """`csrc/<name>.cu` and every header of `csrc/` it includes with
    quotes, directly or through another header, in a fixed order."""
    todo, seen = [CSRC / f"{name}.cu"], {}
    while todo:
        path = todo.pop()
        if path.name in seen:
            continue
        seen[path.name] = path
        for inc in _INCLUDE.findall(path.read_text(encoding="utf-8")):
            todo.append(CSRC / inc)
    return [seen[f"{name}.cu"]] + sorted(
        p for n, p in seen.items() if n != f"{name}.cu")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(name):
        h.update(f"{src.name}:{src.stat().st_size};".encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc_command(name: str, out: Path, extra=()) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names=None, *, verbose_ptxas: bool = False) -> dict[str, float]:
    """Compile the named kernels (all by default) that have no current
    library, one `nvcc` per source, all started together. Returns the
    seconds each build took (0.0 when the library was current). Raises
    with the compiler's output if a build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose_ptxas else ()
    procs, seconds = {}, {}
    t0 = time.monotonic()
    for name in names:
        lib = _library_path(name)
        if lib.exists() and not verbose_ptxas:
            seconds[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_command(name, tmp, extra), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode})\n{log}")
            continue
        if log.strip():
            print(f"nvcc {name}:\n{log.rstrip()}")
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load_kernel(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built if needed, with its entry point's
    argument and result types declared."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
