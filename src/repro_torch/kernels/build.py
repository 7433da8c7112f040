"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <name>.cu

Libraries land in the checkout's git-ignored `build/repro_torch/` when
the package runs from the checkout's `src/`, and in the user's cache
directory (`$XDG_CACHE_HOME/repro_torch`, else `~/.cache/repro_torch`)
when it is installed. Each is named by a hash of its source and of the
headers of `csrc/` (`hopper.cuh`, which K1, K2 and K3 include), so an
edited source or header never loads a stale library. Nothing here runs at
import: the first launch of a kernel builds it, and `build_all()`
starts one `nvcc` per source at once (what `chip_smoke.py` calls up
front).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    pkg = Path(__file__).resolve().parents[1]          # .../repro_torch
    if pkg.parent.name == "src":
        return pkg.parents[1] / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or \
        os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "repro_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: ptxas register / shared-memory report of each build, by source name
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def digest(name: str, csrc: Path = CSRC) -> str:
    """A hash of `<name>.cu` together with every header of `csrc`, which
    any source may include: an edit of either rebuilds the library."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:12]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{digest(name)}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out = _target(name)
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)


def build_all() -> None:
    """Compile every source at once (one nvcc each) and wait for all."""
    with _lock:
        names = [n for n in sources() if n not in _libs]
        procs = {n: _start(n) for n in names}
        try:
            for n in names:
                _finish(n, procs[n])
        finally:
            for p in procs.values():
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
