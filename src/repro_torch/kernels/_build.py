"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA source under ``kernels/<name>/csrc/`` with a plain
C interface; the headers they share live in ``kernels/csrc/``.  A source is
compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use,
into ``build/repro_torch_kernels/`` at the root of the checkout, and loaded
with ctypes.  The library's name carries a hash of the source, the shared
headers and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  Nothing is compiled or loaded when this
module is imported.  Each build counts in ``kernel_builds_total{source}``
and each load in ``kernel_loads_total{source}`` on the process-wide
registry, and the builds that one call waits for are a ``kernel_build``
span (meta ``sources``) on the process-wide tracer.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from ..obs.metrics import get_registry
from ..obs.spans import get_tracer

ROOT = Path(__file__).resolve().parents[3]          # the checkout
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"   # shared headers
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}
_NOTHING = contextlib.nullcontext()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + \
            [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH")
    return found


def _target(source: Path) -> Path:
    h = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"{source.stem}_{tag}.so"


def build_all(sources: Sequence[Path]) -> List[Tuple[Path, str]]:
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together.  Returns ``(library path, ptxas report)`` per source
    in order; the report (registers, shared memory, spills) is what
    ``nvcc -Xptxas -v`` printed for the build.  Raises if any build
    fails, after every started build has ended."""
    jobs = []
    for src in sources:
        so = _target(Path(src))
        report = so.with_suffix(".ptxas.txt")
        if so.exists() and report.exists():
            jobs.append((so, report, None, None, None))
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".{so.name}.{os.getpid()}")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((so, report, tmp, proc, src))
    built = [Path(src).name for *_, proc, src in jobs if proc is not None]
    failed = []
    with get_tracer().span("kernel_build", sources=built) if built \
            else _NOTHING:
        for so, report, tmp, proc, src in jobs:
            if proc is None:
                continue
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {src} failed with code "
                              f"{proc.returncode}:\n{out}")
                continue
            tmp_report = report.with_name(f".{report.name}.{os.getpid()}")
            tmp_report.write_text(out)
            os.replace(tmp, so)
            os.replace(tmp_report, report)
            get_registry().counter("kernel_builds_total",
                                   source=Path(src).name).inc()
    if failed:
        raise RuntimeError("\n".join(failed))
    return [(so, report.read_text()) for so, report, *_ in jobs]


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if need be.  Each
    source is loaded once per process; the caller declares the argtypes
    of the functions it calls."""
    source = Path(source)
    lib = _LOADED.get(source)
    if lib is None:
        (so, _), = build_all([source])
        lib = _LOADED[source] = ctypes.CDLL(str(so))
        get_registry().counter("kernel_loads_total",
                               source=source.name).inc()
    return lib


def readable_name(mangled: str) -> str:
    """``flash_fwd_tc<112>``, ``nvt_probe_batch<4,8>`` or
    ``decode_attn_pv<bf16,2>`` from a kernel's mangled name (a
    namespace, the name, then int, float or bf16 template arguments); the
    name as given where it does not parse so."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    args = re.match(r"I((?:Li\d+E|f|13__nv_bfloat16)+)E",
                    rest[m.end() + len(name):])
    if not args:
        return name
    vals = re.findall(r"Li(\d+)E|(f)|13__nv_bfloat16", args.group(1))
    types = {"f": "float", "": "bf16"}
    return f"{name}<{','.join(i or types[f] for i, f in vals)}>"


def ptxas_functions(report: str) -> Dict[str, dict]:
    """Registers and spill bytes (stores plus loads) of every function in
    a ``ptxas -v`` report, keyed by mangled name."""
    funcs: Dict[str, dict] = {}
    cur = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = funcs.setdefault(m.group(1), {
                "kernel": readable_name(m.group(1)), "registers": None,
                "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return funcs
