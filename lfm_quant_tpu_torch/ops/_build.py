"""Build, load and count the port's CUDA kernels.

``library()`` compiles every ``csrc/*.cu`` source with ``nvcc`` for
``sm_90a`` at first use (one ``nvcc`` per source, all started together,
then one link) into a shared library with a plain C interface under
``build/lfm_quant_tpu_torch/`` in the checkout, and loads it with
``ctypes``. The library's name carries a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags, so an edited source or
header is never served by a stale build. Nothing here
includes PyTorch's headers: pointers and the stream cross as ``c_void_p``.

Every kernel wrapper counts its launches in :data:`LAUNCHES`, one per
launch and nowhere else, so a run can show which kernels its main path
went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lfm_quant_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Launches per kernel since the last :func:`reset_launch_counts`.
LAUNCHES: Dict[str, int] = {
    f"rnn_{form}_{cell}": 0
    for form in ("fused_fwd", "fused_bwd", "fwd", "bwd")
    for cell in ("lstm", "gru")
}
LAUNCHES.update(rnn_fused_fwd_mma_lstm=0, rnn_fused_fwd_mma_gru=0,
                rnn_fwd_mma_lstm=0, rnn_fwd_mma_gru=0,
                rnn_fused_bwd_mma_lstm=0, rnn_fused_bwd_mma_gru=0,
                rnn_bwd_mma_lstm=0, rnn_bwd_mma_gru=0,
                rnn_fused_bwd_tf32_lstm=0, rnn_fused_bwd_tf32_gru=0,
                rnn_bwd_tf32_lstm=0, rnn_bwd_tf32_gru=0,
                rnn_fused_fwd_tf32_lstm=0, rnn_fused_fwd_tf32_gru=0,
                rnn_fwd_tf32_lstm=0, rnn_fwd_tf32_gru=0,
                rnn_fused_fwd_cluster_lstm=0, rnn_fused_fwd_cluster_gru=0,
                rnn_fwd_cluster_lstm=0, rnn_fwd_cluster_gru=0,
                rnn_fused_bwd_cluster_lstm=0, rnn_fused_bwd_cluster_gru=0,
                rnn_bwd_cluster_lstm=0, rnn_bwd_cluster_gru=0,
                rnn_fused_bwd_grid_lstm=0, rnn_fused_bwd_grid_gru=0,
                rnn_bwd_grid_lstm=0, rnn_bwd_grid_gru=0,
                rnn_fused_bwd_grid_bf16_lstm=0, rnn_fused_bwd_grid_bf16_gru=0,
                rnn_bwd_grid_bf16_lstm=0, rnn_bwd_grid_bf16_gru=0,
                rnn_fused_fwd_grid_bf16_lstm=0, rnn_fused_fwd_grid_bf16_gru=0,
                rnn_fwd_grid_bf16_lstm=0, rnn_fwd_grid_bf16_gru=0,
                rnn_fused_fwd_grid_lstm=0, rnn_fused_fwd_grid_gru=0,
                rnn_fwd_grid_lstm=0, rnn_fwd_grid_gru=0,
                window_gather=0)

_count_lock = threading.Lock()
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Seconds the build took in this process and the compiler's register and
#: shared-memory report (``-Xptxas -v``); None until ``library()`` built.
BUILD_INFO: Dict[str, object] = {"seconds": None, "ptxas": None}


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(cuda_home, "bin", "nvcc") if cuda_home
                  else None), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "kernels are built from csrc/ on the machine with the card")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    """Compile and link the library (if this digest is not built yet)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    so = BUILD_DIR / f"liblfm_kernels-{digest}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    from lfm_quant_tpu_torch.utils import telemetry

    # The builds a run paid (a restore's compile cost: none when this
    # digest's library is already on disk).
    telemetry.COUNTERS.bump("kernel_builds")
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}-{digest}.o"
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        objs.append(str(BUILD_DIR / f"{src.stem}-{digest}.o"))
        if p.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = so.with_suffix(".so.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *objs, "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    (BUILD_DIR / f"ptxas-{digest}.log").write_text(log)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["ptxas"] = log
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _build_lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the port's kernels need a CUDA device")
            so = _build()
            lib = ctypes.CDLL(str(so))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            cf, cll = ctypes.c_float, ctypes.c_longlong
            signatures = {
                "lfm_rnn_fused_fwd": [ci, ci] + [vp] * 7 + [ci] * 5
                + [cll] * 5 + [cf, vp],
                "lfm_rnn_fused_fwd_mma": [ci] + [vp] * 7 + [ci] * 5
                + [cll] * 5 + [cf, vp],
                "lfm_rnn_scan_fwd_mma": [ci] + [vp] * 5 + [ci] * 5
                + [cll] * 3 + [cf, vp],
                "lfm_rnn_fused_bwd_mma": [ci] + [vp] * 13 + [ci, vp]
                + [ci] * 4 + [cll] * 5 + [cf, vp],
                "lfm_rnn_scan_bwd_mma": [ci] + [vp] * 9 + [ci, vp]
                + [ci] * 4 + [cll] * 3 + [cf, vp],
                "lfm_rnn_scan_fwd": [ci, ci] + [vp] * 5 + [ci] * 5
                + [cll] * 3 + [cf, vp],
                "lfm_rnn_fused_bwd": [ci, ci] + [vp] * 14 + [ci, vp]
                + [ci] * 5 + [cll] * 5 + [cf, vp],
                "lfm_rnn_scan_bwd": [ci, ci] + [vp] * 11 + [ci, vp]
                + [ci] * 5 + [cll] * 3 + [cf, vp],
                "lfm_rnn_bwd_tf32": [ci, ci] + [vp] * 12 + [ci, vp]
                + [ci] * 6 + [cll] * 5 + [cf, vp],
                "lfm_rnn_bwd_tf32_clusters": [ci] * 4,
                "lfm_rnn_fwd_tf32": [ci, ci] + [vp] * 8 + [ci] * 4
                + [cll] * 5 + [cf, vp],
                "lfm_rnn_fwd_cluster": [ci, ci] + [vp] * 8 + [ci] * 6
                + [cll] * 5 + [cf, vp],
                "lfm_rnn_fwd_cluster_clusters": [ci] * 5,
                "lfm_rnn_bwd_cluster": [ci, ci] + [vp] * 12 + [ci, vp]
                + [ci] * 7 + [cll] * 5 + [cf, vp],
                "lfm_rnn_bwd_cluster_clusters": [ci] * 5,
                "lfm_rnn_bwd_tf32_grid": [ci, ci] + [vp] * 12 + [ci]
                + [vp] * 3 + [ci] * 7 + [cll] * 5 + [cf, vp, vp],
                "lfm_rnn_bwd_grid_ctas": [ci] * 4,
                "lfm_rnn_bwd_grid_bf16": [ci, ci] + [vp] * 13 + [ci]
                + [vp] * 3 + [ci] * 7 + [cll] * 5 + [cf, vp, vp],
                "lfm_rnn_bwd_grid_bf16_ctas": [ci] * 4,
                "lfm_rnn_fwd_grid": [ci, ci] + [vp] * 10 + [ci] * 7
                + [cll] * 5 + [cf, vp, vp],
                "lfm_rnn_fwd_grid_ctas": [ci] * 5,
                "lfm_rnn_fwd_tf32_grid": [ci, ci] + [vp] * 10 + [ci] * 7
                + [cll] * 5 + [cf, vp, vp],
                "lfm_rnn_fwd_tf32_grid_ctas": [ci] * 4,
            }
            for name, args in signatures.items():
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = ci
            smem = {"lfm_rnn_fwd_smem": 4, "lfm_rnn_bwd_smem": 4,
                    "lfm_rnn_fused_fwd_mma_smem": 3,
                    "lfm_rnn_scan_fwd_mma_smem": 3,
                    "lfm_rnn_fused_bwd_mma_smem": 2,
                    "lfm_rnn_scan_bwd_mma_smem": 2,
                    "lfm_rnn_bwd_tf32_smem": 4, "lfm_rnn_fwd_tf32_smem": 2,
                    "lfm_rnn_fwd_cluster_smem": 4,
                    "lfm_rnn_bwd_cluster_smem": 4,
                    "lfm_rnn_bwd_grid_smem": 4,
                    "lfm_rnn_bwd_grid_bf16_smem": 4,
                    "lfm_rnn_fwd_grid_smem": 4,
                    "lfm_rnn_fwd_tf32_grid_smem": 4}
            for name, n in smem.items():
                getattr(lib, name).argtypes = [ci] * n
                getattr(lib, name).restype = cll
            lib.lfm_window_gather.argtypes = [
                ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
            lib.lfm_window_gather.restype = ci
            lib.lfm_cuda_error_string.argtypes = [ci]
            lib.lfm_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib.lfm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' dtype argument."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
