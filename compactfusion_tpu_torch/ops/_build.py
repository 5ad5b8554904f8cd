"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them.

Route: a plain C interface, one ``nvcc -c`` per source run in parallel and
linked into one shared library bound with ``ctypes`` (no PyTorch headers,
so the build takes seconds).  The library goes to ``build/kernels/`` at the
root of the checkout, named after a hash of the sources and flags, so an
edited kernel rebuilds and an unchanged one is loaded as it is.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: sources compiled as several objects, one ``nvcc -c`` per define, all in
#: parallel: flash_attn.cu's full and banded kernels (its one object took 78
#: of the build's 79 s on an H100 machine's 8 cores), and flash_wgmma.cu's
#: kernel 1 and kernel 7
PARTS = {"flash_attn.cu": ("-DCF_FLASH_PART=1", "-DCF_FLASH_PART=2"),
         "flash_wgmma.cu": ("-DCF_WG_PART=1", "-DCF_WG_PART=2")}

#: seconds the last build took (0.0 when the library was already built)
last_build_seconds = 0.0
#: what ptxas said about registers, shared memory and spills, per kernel
last_build_log = ""


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    return BUILD_DIR / f"libcftorch_{h.hexdigest()[:16]}.so"


def compile_objects(csrc: Path, obj_dir: Path):
    """One ``nvcc -c`` per ``csrc/*.cu`` (per part of one in
    :data:`PARTS`), all started together, into ``obj_dir``; returns (the
    objects, what the compiler printed)."""
    obj_dir.mkdir(parents=True, exist_ok=True)
    jobs = []  # (source, object stem, defines)
    for cu in sorted(csrc.glob("*.cu")):
        parts = PARTS.get(cu.name)
        jobs += [(cu, f"{cu.stem}.{i}", [d]) for i, d in enumerate(parts, 1)] if parts else [(cu, cu.stem, [])]
    cus = [cu for cu, _, _ in jobs]
    objs = [obj_dir / f"{stem}.o" for _, stem, _ in jobs]
    procs = [
        subprocess.Popen([_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, *define, "-c", "-I", str(csrc), "-o", str(obj),
                          str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for (cu, _, define), obj in zip(jobs, objs)
    ]
    log, failed = "", []
    for cu, proc in zip(cus, procs):
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(cu.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    return objs, log


def _compile(out: Path) -> str:
    """The objects of :func:`compile_objects`, then one link; returns what
    the compiler printed."""
    obj_dir = out.with_name(f"{out.stem}.{os.getpid()}.objs")
    objs, log = compile_objects(CSRC, obj_dir)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    link = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, out)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; one load per process."""
    global last_build_seconds, last_build_log
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        last_build_log = _compile(out)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L = ctypes.c_longlong
    lib.cf_flash_attn.argtypes = [
        P, P, P,          # q, k, v
        L, L, L,          # q strides (b, s, h) in elements
        L, L, L,          # k strides
        L, L, L,          # v strides
        P, P, P,          # out (B,Sq,H,D) contiguous, lse (B,H,Sq), kv_lens or NULL
        I, I, I, I, I,    # B, Sq, Sk, H, D
        F,                # softmax scale
        I, I, I,          # plan: body, padded head dim, warps per CTA (ops/flash.py)
        I,                # q/k/v and out are fp32 (else bf16)
        P,                # stream
    ]
    lib.cf_flash_attn.restype = I
    lib.cf_flash_attn_window.argtypes = [
        P, P, P,          # q, k, v
        L, L, L,          # q strides (b, s, h) in elements
        L, L, L,          # k strides
        L, L, L,          # v strides
        P, P,             # out (B,S,H,D) contiguous, lse (B,H,S)
        I, I, I, I,       # B, S, H, D
        I,                # window
        F,                # softmax scale
        I, I, I,          # plan: body, padded head dim, warps per CTA
        I,                # q/k/v and out are fp32 (else bf16)
        P,                # stream
    ]
    lib.cf_flash_attn_window.restype = I
    lib.cf_tma_map.argtypes = [
        P, P,             # the map (128 bytes, written), the view's first element
        L, L, L, L,       # dims (D, S, H, B) in elements
        L, L, L,          # byte strides of S, H, B
        I, I, I,          # box columns, box rows, swizzle bytes (ops/flash.py::tma_view)
    ]
    lib.cf_tma_map.restype = I
    lib.cf_flash_wgmma.argtypes = [
        P, P, P, P, P, P,  # the maps of q, k, v (cf_tma_map): 64-column boxes, the tail's or NULL
        P, P, P,          # out (B,Sq,H,D) contiguous, lse (B,H,Sq), kv_lens or NULL
        I, I, I, I, I,    # B, Sq, Sk, H, D
        F,                # softmax scale
        I, I,             # plan: padded head dim, consumer warps per CTA (ops/flash.py)
        P,                # stream
    ]
    lib.cf_flash_wgmma.restype = I
    lib.cf_ring_flash_hop_wgmma.argtypes = [
        P, P, P, P, P, P,  # the maps of q, k, v (cf_tma_map): 64-column boxes, the tail's or NULL
        P, P, P,          # running state m, l (B,H,Sq), acc (B,H,Sq,D) fp32
        P, P,             # out (B,Sq,H,D) contiguous, lse (B,H,Sq)
        I, I, I, I, I,    # B, Sq, Sk, H, D
        F,                # softmax scale
        I, I,             # first hop, last hop
        I, I,             # plan: padded head dim, consumer warps per CTA
        P,                # stream
    ]
    lib.cf_ring_flash_hop_wgmma.restype = I
    for codec in ("binary", "int2"):
        quant, dequant = getattr(lib, f"cf_{codec}_quant"), getattr(lib, f"cf_{codec}_dequant")
        quant.argtypes = [
            P, P, P, P, P, P,  # x, base, u, v, packed, new_base
            I, I, I,           # N, C, K
            I, I,              # x is bf16, base is bf16
            I,                 # plan: packed bytes per thread (ops/quant.py)
            P,                 # stream
        ]
        quant.restype = I
        dequant.argtypes = [
            P, P, P, P, P,     # packed, base, u, v, out
            I, I, I,           # N, C, K
            I,                 # base (and out) is bf16
            I,                 # plan: packed bytes per thread (ops/quant.py)
            P,                 # stream
        ]
        dequant.restype = I
    lib.cf_ring_flash_hop.argtypes = [
        P, P, P,          # q, k, v
        L, L, L,          # q strides (b, s, h) in elements
        L, L, L,          # k strides
        L, L, L,          # v strides
        P, P, P,          # running state m, l (B,H,Sq), acc (B,H,Sq,D) fp32
        P, P,             # out (B,Sq,H,D) contiguous, lse (B,H,Sq)
        I, I, I, I, I,    # B, Sq, Sk, H, D
        F,                # softmax scale
        I, I,             # first hop, last hop
        I, I, I,          # plan: body, padded head dim, warps per CTA
        I,                # q/k/v and out are fp32 (else bf16)
        P,                # stream
    ]
    lib.cf_ring_flash_hop.restype = I
    lib.cf_ef_update_slot.argtypes = [
        P, P,             # packed codes of K and V (NULL for LOW_RANK)
        P, P, P, P, I,    # u_k, u_v (N,K), v_k, v_v (K,C) bf16, K
        P, P, P,          # K base slot: fp32 or int8 codes, int8 scale, int8 min
        P, P, P,          # V base slot
        P, P,             # reconstruction of K and V (B,Sk,H,D), or NULL (hop 0)
        P, P, I,          # int8 scratch: tile min/max (2,T,2,C) fp32, old scale/min (2,2,C) bf16, T
        I, I, I, I,       # B, Sk, H, D
        I, I,             # codec (0 binary, 1 int2, 2 lowrank), quantized
        I,                # the reconstruction is fp32 (else bf16)
        P,                # stream
    ]
    lib.cf_ef_update_slot.restype = I
    lib.cf_flash_parts_bf16.argtypes = [
        P, P, P,          # q, k, v
        L, L, L,          # q strides (b, s, h) in elements
        L, L, L,          # k strides
        L, L, L,          # v strides
        P, P,             # out (B,S,H,D) contiguous, lse (B,H,S)
        I, I, I, I,       # B, S, H, D
        F,                # softmax scale
        I,                # stage mask (0: dma_only)
        I, I,             # padded head dim, warps per CTA (the probe's plan)
        P,                # stream
    ]
    lib.cf_flash_parts_bf16.restype = I
    lib.cf_plumb_bf16.argtypes = [
        P, P, P,          # q, k, v
        L, L, L,          # q strides (b, s, h) in elements
        L, L, L,          # k strides
        L, L, L,          # v strides
        P,                # out (B,S,H,D) contiguous
        I, I, I, I,       # B, S, H, D
        P,                # stream
    ]
    lib.cf_plumb_bf16.restype = I
    lib.cf_empty.argtypes = [P]  # stream
    lib.cf_empty.restype = I
    lib.cf_error_string.argtypes = [I]
    lib.cf_error_string.restype = ctypes.c_char_p


def _cufilt() -> str:
    found = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not Path(found).exists():
        raise RuntimeError("cu++filt not found: kernel names are read only where the CUDA toolkit is installed")
    return found


def kernel_labels(mangled) -> dict:
    """{mangled name: its label}: the name as ``cu++filt -p`` demangles it,
    e.g. ``flash_fwd_reg_kernel<80, 8>``, without the anonymous namespace nvcc
    gives each ``csrc`` source (its name changes with the source) and the
    casts of integer template arguments."""
    mangled = list(mangled)
    said = subprocess.run([_cufilt(), "-p"], input="\n".join(mangled), capture_output=True, text=True,
                          check=True).stdout.splitlines()
    return {m: _UNLABELLED.sub("", d) for m, d in zip(mangled, said)}


# cu++filt says "<unnamed>::" and "(int)4"; GNU c++filt "(anonymous namespace)::" and "4"
_UNLABELLED = re.compile(r"<unnamed>::|\(anonymous namespace\)::|\(int\)")


def ptxas_summary(log: str) -> dict:
    """{kernel (its label, :func:`kernel_labels`): what ptxas said of it}:
    its stack frame and spills, then its registers, barriers and constant
    memory, from the ``-Xptxas -v`` output of a build (``last_build_log``)."""
    out, name = {}, None
    for line in log.splitlines():
        text = line.split(":", 1)[1].strip() if line.startswith("ptxas info") else line.strip()
        if text.startswith("Compiling entry function"):
            name = text.split("'")[1]
            out[name] = ""
        elif name is not None and ("stack frame" in text or text.startswith("Used")):
            out[name] = f"{out[name]}; {text}" if out[name] else text
    labels = kernel_labels(out)
    return {labels[name]: said for name, said in out.items()}


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        msg = load().cf_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")
