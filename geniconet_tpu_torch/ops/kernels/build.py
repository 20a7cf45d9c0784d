"""Build the CUDA kernels with nvcc, load them with ctypes, and check launches.

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), for
``sm_90a`` (Hopper): one nvcc process per source file, in parallel, then
one link. The library is named by a hash of the sources and
flags, so a fresh checkout builds at first use and an unchanged one reuses
its build. It lands in ``build/kernels/`` at the repo root when the package
is imported from a checkout, and in ``~/.cache/geniconet_tpu_torch/kernels``
when it is installed. A failed build raises.

Every wrapper that launches a kernel adds one to ``LAUNCHES[name]`` right
there, so a caller can show which kernels a run went through. The argument
checks and the act prologue that all wrappers share live here too.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = [
    "LAUNCHES", "reset_launches", "build", "library", "check", "stream_ptr", "ptr",
    "ptr_array", "dtype_code", "on_cuda", "expect", "check_act", "act_apply", "grid_level",
    "TILE", "GSUM_ROWS", "n_tiles", "dtaps_split", "scratch", "merged_scratch",
]

CSRC = Path(__file__).resolve().parents[2] / "csrc"


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").exists() and (root / "geniconet_tpu_torch").is_dir():
        return root / "build" / "kernels"  # a checkout of the repo
    return Path.home() / ".cache" / "geniconet_tpu_torch" / "kernels"  # an installed copy


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_LIB = None
_LOCK = threading.Lock()


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built")
    return cand


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source hash has no library yet; return its
    path. One nvcc per ``.cu`` file, all started together, then one link."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libgeniconet_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in sorted(CSRC.glob("*.cu"))]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", f"-I{CSRC}", "-o", str(obj),
                                   str(CSRC / f"{obj.stem}.cu")],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for obj in objs]
        logs = [(p, *p.communicate()) for p in procs]
        failed = [err for p, _, err in logs if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = Path(work) / "lib.so"
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        if verbose:
            print("".join(err for _, _, err in logs), end="")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


_VP, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # pointers, then ints, then the stream; csrc/*.cu documents each argument
    "gn_phase_conv_fwd": [_VP] * 15 + [_INT] * 9 + [_VP],
    "gn_up_dual_conv_fwd": [_VP] * 11 + [_INT] * 7 + [_VP],
    "gn_pair_head_fwd": [_VP] * 8 + [_INT] * 6 + [_VP],
    "gn_pair_head_bwd": [_VP] * 16 + [_INT] * 6 + [_VP],
    "gn_pair_head_mse_fwd": [_VP] * 11 + [_INT] * 6 + [_VP],
    "gn_pair_head_mse_bwd": [_VP] * 19 + [_INT] * 6 + [_VP],
    "gn_ico_conv_fwd": [_VP] * 9 + [_INT] * 6 + [_VP],
    "gn_ico_conv_dx": [_VP] * 16 + [_INT] * 7 + [_VP],
    "gn_ico_conv_dtaps": [_VP] * 9 + [_INT] * 8 + [_VP],
    "gn_phase_conv_dx": [_VP] * 19 + [_INT] * 9 + [_VP],
    "gn_phase_conv_dtaps": [_VP] * 14 + [_INT] * 12 + [_VP],
    "gn_up_dual_conv_dx": [_VP] * 13 + [_INT] * 8 + [_VP],
    "gn_up_dual_conv_dtaps": [_VP] * 10 + [_INT] * 9 + [_VP],
    "gn_phase_conv_bwd": [_VP] * 23 + [_INT] * 11 + [_VP],
    "gn_up_dual_conv_bwd": [_VP] * 19 + [_INT] * 9 + [_VP],
    "gn_ico_conv_bwd": [_VP] * 19 + [_INT] * 8 + [_VP],
    "gn_ds2s_fwd": [_VP] * 15 + [_INT] * 7 + [_VP],
    "gn_ds2s_dx": [_VP] * 19 + [_INT] * 8 + [_VP],
    "gn_ds2s_dtaps": [_VP] * 14 + [_INT] * 10 + [_VP],
    "gn_stats_geff": [_VP] * 4 + [_INT, _I64, _INT, _INT, _VP],
    "gn_up_pair_fwd": [_VP] * 12 + [_INT] * 6 + [_VP],
    "gn_up_pair_dx": [_VP] * 17 + [_INT] * 7 + [_VP],
    "gn_up_pair_dtaps": [_VP] * 11 + [_INT] * 8 + [_VP],
}

# Work split shared with csrc/: the GEMM cores compute TILE x TILE output
# tiles; reductions across blocks write float32 partials to a scratch buffer
# that a second pass sums in a fixed order, so every sum is deterministic.
TILE = 64
GSUM_ROWS = 1024  # rows of g summed by one block of the bias-gradient pass
_TARGET_BLOCKS = 1056  # 8 blocks for each of the H100's 132 SMs


def n_tiles(n: int) -> int:
    return -(-n // TILE)


def dtaps_split(rows: int, out_tiles: int):
    """(rows per chunk, chunks) for a dtaps reduction over ``rows`` rows
    into ``out_tiles`` output tiles: enough chunks to fill the card, each a
    multiple of the 16-row K step."""
    want = max(1, min(-(-_TARGET_BLOCKS // out_tiles), -(-rows // 256)))
    kc = -(-rows // want)
    kc = -(-kc // 16) * 16
    return kc, -(-rows // kc)


def scratch(n: int, device) -> torch.Tensor:
    """A float32 scratch buffer of n values for the partial sums."""
    return torch.empty(max(n, 1), dtype=torch.float32, device=device)


def merged_scratch(rows: int, cin: int, ntot: int, device):
    """(kc, n_chunks, dtaps partials, Σg partials) of a merged backward
    kernel whose dtaps reduce over ``rows`` rows of g into (7·cin, ntot)."""
    kc, n_chunks = dtaps_split(rows, n_tiles(7 * cin) * n_tiles(ntot))
    return (kc, n_chunks, scratch(n_chunks * 7 * cin * ntot, device),
            scratch(n_chunks * ntot, device))


def library(verbose: bool = False):
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gn_error_string.argtypes = [ctypes.c_int]
            lib.gn_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(name: str, err: int):
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().gn_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def ptr_array(tensors):
    """A host array of device pointers, for the kernels' pointer-list arguments."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def dtype_code(dtype: torch.dtype) -> int:
    """0 = float32, 1 = bfloat16: the activation types the kernels take."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def on_cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); raise for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def expect(t: torch.Tensor, shape, dtype, device, name: str):
    """Raise unless t has this shape, dtype and device and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_act(act, cin, device, name):
    if act is not None:
        for a in act:
            expect(a, (cin,), torch.float32, device, f"{name} act")


def act_apply(x: torch.Tensor, act) -> torch.Tensor:
    """The kernels' prologue relu(x·mul + add): float32 math, input dtype out."""
    if act is None:
        return x
    mul, add = act
    return torch.clamp_min(x.float() * mul + add, 0.0).to(x.dtype)


def grid_level(h: int, w: int) -> int:
    """Subdivision level s of a (h, w) = (2^s, 2^(s+1)) chart."""
    s = h.bit_length() - 1
    if h != 1 << s or w != 2 * h:
        raise ValueError(f"not an icosahedral chart shape: ({h}, {w})")
    return s
