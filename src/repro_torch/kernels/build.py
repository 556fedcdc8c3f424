"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/<hash of the sources and flags>/`` at the repository root
(listed in ``.gitignore``).  All missing libraries are compiled at once,
one ``nvcc`` process per source; each one's compiler output, with
``ptxas``'s registers, shared memory and spills per kernel, is kept beside
it as ``lib<name>.log``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("decode_attention", "flash_attention", "moe_gemm",
           "paged_decode_attention", "rglru_scan", "rmsnorm", "rwkv6_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        from torch.utils.cpp_extension import CUDA_HOME
        cand = os.path.join(CUDA_HOME or "", "bin", "nvcc")
        exe = cand if CUDA_HOME and os.path.exists(cand) else None
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled from "
            f"{CSRC} at first use and need the CUDA toolkit")
    return exe


def build_all() -> Dict[str, Path]:
    """Compile every kernel whose library is missing, all ``nvcc``
    processes started together.  Returns kernel name -> library path."""
    out_dir = BUILD_DIR / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in KERNELS}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode:
            errors.append(f"--- {name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)   # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(errors))
    return libs


def ptxas_report(name: str):
    """Each kernel of library ``name`` as ptxas reported it at the build:
    [{"kernel", "registers", "spill_stores", "spill_loads", "static_smem"}]
    (bytes; dynamic shared memory is the launcher's and not in the log),
    names demangled where ``c++filt`` is on the path."""
    log = (BUILD_DIR / _digest() / f"lib{name}.log").read_text()
    rows, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            rows.append(dict(kernel=kernel, spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2))))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and "registers" not in rows[-1]:
            rows[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem"] = int(m.group(1)) if m else 0
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True)
        for r, n in zip(rows, names.stdout.splitlines()):
            r["kernel"] = n
    return rows


@functools.lru_cache(maxsize=None)
def check_device(device: torch.device) -> None:
    """The kernels are compiled for sm_90a only: raise on any other card
    (checked once per device)."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's CUDA kernels target Hopper (sm_90a); "
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
    return lib
