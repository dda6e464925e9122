"""Build and load the port's CUDA kernels (``ceph_tpu_torch/csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), at first use, and loaded with
``ctypes``.  The library's name carries a hash of the source and the
flags, so an edited source rebuilds and a stale library is never loaded.
Nothing here runs at import time; any build or load failure raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": build wall time, "ptxas": [per-kernel resources]}
# of the builds this process ran (empty for a library already built)
build_log: Dict[str, dict] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels are built from ceph_tpu_torch/csrc at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu``; None when already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: concurrent builders never see half
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": parse_ptxas(log)}


def entry_label(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_117xor_matmul_kernelILi24ELi4EEEv...' ->
    'xor_matmul_kernel<24,4>' (integer template arguments only)."""
    pos = 0
    while True:
        m = re.compile(r"\d+").search(mangled, pos)
        if m is None:
            return mangled
        n = int(m.group())
        ident = mangled[m.end():m.end() + n]
        rest = mangled[m.end() + n:]
        if rest.startswith("I"):
            args = re.findall(r"Li(-?\d+)E", rest.split("EE", 1)[0] + "E")
            return f"{ident}<{','.join(args)}>"
        pos = m.end() + max(n, 1)


def parse_ptxas(log: str) -> List[dict]:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: registers, static
    shared memory and spill bytes."""
    out: List[dict] = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            out.append({"entry": entry_label(m.group(1)), "registers": None,
                        "smem": 0, "spill_stores": None,
                        "spill_loads": None})
        elif out and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(st), int(ld)
        elif out and "Used " in ln:
            out[-1]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[-1]["smem"] = int(sm.group(1)) if sm else 0
    return out


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Iterable[str] = ()) -> None:
    """Build every named source (default: all of csrc/), one nvcc per
    source, all started together."""
    names = list(names) or sources()
    with _lock:
        started = []
        try:
            for n in names:
                started.append((n, _start(n)))
            for n, s in started:
                if s is not None:
                    _finish(n, s)
        finally:
            for _, s in started:     # a failed build stops the others
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
