"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land under
``build/repro_torch_kernels/<name>-<hash>/`` at the repository root, keyed by
a hash of the sources and flags, at first use; :func:`build` compiles several
sources in parallel, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
KERNEL_SOURCES = ("flash_attention", "paged_attention", "ssd_scan")

# Element type codes of csrc/common.cuh (repro::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the port's kernels")
    return str(path)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed by the
    flags, the source and every header of ``csrc/``, so a changed or new
    header never leaves a stale library behind."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes at once.  Returns each fresh build's compiler output
    (``-Xptxas -v``: registers, shared memory, spills) and raises with that
    output when a build fails."""
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.monotonic())
    logs = {}
    for name, (proc, tmp, out, t0) in running.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{text}")
        os.replace(tmp, out)      # atomic: a concurrent build loses nothing
        logs[name] = f"built in {time.monotonic() - t0:.1f} s\n{text}"
        (out.parent / "build.log").write_text(logs[name])
    return logs


def refuse_autograd(op: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and a tensor input of
    ``op`` requires grad.  A kernel's output is written through ``ctypes``
    and has no ``grad_fn``, so a gradient through it would be lost without
    a word; the plain version on the CPU would keep it, and a CPU test would
    not see the fault.  The rule holds on both devices."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} has no backward: training attention runs "
            f"models/attention.py::gqa_attend or models/blockwise.py::"
            f"blockwise_gqa_attend (attn_forward(..., train=True)), the "
            f"training SSM models/ssm.py::ssd_chunked (ssm_forward(..., "
            f"train=True)); call the kernel wrappers under torch.no_grad() "
            f"or with inputs that do not require grad")


# Callables ``sink(kernel, flops, nbytes)`` that a wrapper called on meta
# tensors reports its kernel's work to (``launch/op_count.py::OpCounter``
# adds itself while it counts).
COUNT_SINKS: list = []


def report_meta(kernel: str, flops: float, nbytes: float) -> None:
    """Tell every active counter that a wrapper ran ``kernel`` on meta
    tensors, which would have done ``flops`` and moved ``nbytes``."""
    for sink in COUNT_SINKS:
        sink(kernel, flops, nbytes)


class CudaKernel:
    """One kernel library (``csrc/<name>.cu``): built and loaded at its first
    launch, with a count of the launches made through :meth:`launch`."""

    def __init__(self, name: str, function: str, argtypes: list):
        self.name = name
        self.function = function
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self) -> None:
        """Build the library if needed and bind its C function."""
        if self._fn is not None:
            return
        build([self.name])
        lib = ctypes.CDLL(str(library_path(self.name)))
        fn = getattr(lib, self.function)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream (appended as the last
        argument); raise if the launch was refused.  Counts the launch."""
        self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, stream)
        if rc != 0:
            reason = self._lib.repro_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{rc} ({reason})")
        self.launches += 1
