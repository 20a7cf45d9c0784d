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
    "MMA_TILE", "MMA_K_STEP", "MMA_TARGET_BLOCKS", "mma_dtaps_blocks", "mma_dtaps_split",
    "mma_narrow", "mma_taps_per_block", "grid_dtaps_split", "operand_width", "mma_dtaps_info",
    "grid_dtaps_info", "mma_fwd_grid", "packed_taps_shape", "mma_fwd_info",
    "grid_fwd_info", "block_fwd_info", "dx_packed_taps_shape", "cot_operand_shape", "mma_dx_info",
    "up_bwd_info", "phase_bwd_info", "std_bwd_info", "ds2s_fwd_info", "PAIR_ADJOINT_ROWS",
    "pair_adjoint_blocks",
    "HEAD_BWD_BLOCKS", "head_bwd_blocks", "HEAD_MSE_CELLS", "head_mse_parts", "MAX_SLOTS",
    "MAX_SM_IDS",
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


_VP, _INT, _I64, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # pointers, then ints, then the stream; csrc/*.cu documents each argument
    "gn_phase_conv_fwd": [_VP] * 17 + [_INT] * 10 + [_VP],
    "gn_phase_conv_fwd_info": [_INT, _VP],
    "gn_up_dual_conv_fwd": [_VP] * 13 + [_INT] * 8 + [_VP],
    "gn_up_dual_conv_fwd_info": [_INT, _VP],
    "gn_pair_head_fwd": [_VP] * 8 + [_INT] * 6 + [_VP],
    "gn_pair_head_bwd": [_VP] * 16 + [_INT] * 6 + [_VP],
    "gn_pair_head_mse_fwd": [_VP] * 11 + [_INT] * 6 + [_VP],
    "gn_pair_head_mse_bwd": [_VP] * 19 + [_INT] * 6 + [_VP],
    "gn_ico_conv_fwd": [_VP] * 11 + [_INT] * 8 + [_VP],
    "gn_ico_conv_fwd_info": [_INT, _VP],
    "gn_ico_conv_dx": [_VP] * 23 + [_INT] * 9 + [_VP],
    "gn_ico_conv_dx_info": [_INT, _VP],
    "gn_ico_conv_dtaps": [_VP] * 10 + [_INT] * 10 + [_VP],
    "gn_ico_conv_dtaps_info": [_INT, _INT, _VP],
    "gn_phase_conv_dx": [_VP] * 26 + [_INT] * 10 + [_VP],
    "gn_phase_conv_dx_info": [_INT, _VP],
    "gn_phase_conv_dtaps": [_VP] * 15 + [_INT] * 13 + [_VP],
    "gn_phase_conv_dtaps_info": [_INT, _INT, _VP],
    "gn_grid_operand": [_VP] * 4 + [_INT] * 7 + [_VP],
    "gn_up_dual_conv_dx": [_VP] * 24 + [_INT] * 9 + [_VP],
    "gn_up_dual_conv_dx_info": [_VP],
    "gn_up_dual_conv_dtaps": [_VP] * 11 + [_INT] * 10 + [_VP],
    "gn_up_operand": [_VP] * 3 + [_INT] * 6 + [_VP],
    "gn_up_dual_conv_dtaps_info": [_INT, _VP],
    "gn_phase_conv_bwd": [_VP] * 31 + [_INT] * 14 + [_VP],
    "gn_phase_conv_bwd_info": [_INT, _INT, _VP],
    "gn_up_dual_conv_bwd": [_VP] * 31 + [_INT] * 12 + [_VP],
    "gn_up_dual_conv_bwd_info": [_VP],
    "gn_ico_conv_bwd": [_VP] * 27 + [_INT] * 12 + [_VP],
    "gn_ico_conv_bwd_info": [_INT, _INT, _VP],
    "gn_ds2s_fwd": [_VP] * 17 + [_INT] * 8 + [_VP],
    "gn_ds2s_fwd_info": [_INT, _VP],
    "gn_ds2s_dx": [_VP] * 26 + [_INT] * 9 + [_VP],
    "gn_ds2s_dx_info": [_INT, _VP],
    "gn_ds2s_dtaps": [_VP] * 15 + [_INT] * 11 + [_VP],
    "gn_ds2s_dtaps_info": [_INT, _INT, _VP],
    "gn_stats_geff": [_VP] * 4 + [_INT, _I64, _INT, _INT, _VP],
    "gn_up_pair_fwd": [_VP] * 15 + [_INT] * 7 + [_VP],
    "gn_up_pair_fwd_info": [_INT, _VP],
    "gn_up_pair_dx": [_VP] * 28 + [_INT] * 8 + [_VP],
    "gn_up_pair_dx_info": [_VP],
    "gn_up_pair_dtaps": [_VP] * 13 + [_INT] * 9 + [_VP],
    "gn_up_pair_operand": [_VP] * 5 + [_INT] * 6 + [_VP],
    "gn_up_pair_dtaps_info": [_INT, _VP],
    "gn_up_block_fwd": [_VP] * 18 + [_INT] * 6 + [_FLT] * 2 + [_INT] * 2 + [_VP],
    "gn_dn_block_fwd": [_VP] * 20 + [_INT] * 6 + [_FLT] * 2 + [_INT] * 2 + [_VP],
    "gn_up_block_fwd_info": [_VP],
    "gn_dn_block_fwd_info": [_VP],
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


# The tensor-core dtaps (csrc/mma_dtaps.cuh): a block takes a 128 x 128
# output tile (a tap's 128 channels x 128 columns), 32 rows of the reduction
# a pipeline step, 2 blocks an SM.
MMA_TILE = 128
MMA_K_STEP = 32
MMA_TARGET_BLOCKS = 264  # 2 blocks for each of the H100's 132 SMs


def mma_narrow(cin: int) -> bool:
    """Whether the grid convs' tensor-core dtaps take the NARROW tile at this
    C_in: at most 64 (an operand row fills at most half of a block's
    MMA_TILE channels), so one block holds several taps
    (``csrc/mma_dtaps.cuh:mma_narrow`` says the same)."""
    return operand_width(cin) <= MMA_TILE // 2


def mma_taps_per_block(cin: int) -> int:
    """Taps a block of the tensor-core dtaps holds: on the NARROW tile as
    many whole operand rows (``operand_width(cin) / 8`` chunks of 8
    channels) as its 16 chunks fit, at most 7 (all of them for a C_in of at
    most 16); else 1 (``csrc/mma_dtaps.cuh:mma_taps_per_block``)."""
    cpt = operand_width(cin) // 8
    return 1 if cpt > 8 else min(7, (MMA_TILE // 8) // cpt)


def mma_dtaps_blocks(cin: int, ntot: int, narrow: bool = False) -> int:
    """Blocks of one chunk of the tensor-core dtaps: the 7 taps' channel
    tiles (with ``narrow``, the blocks of ``mma_taps_per_block`` taps each)
    times the column tiles."""
    if narrow:
        tiles = -(-7 // mma_taps_per_block(cin))
    else:
        tiles = 7 * -(-cin // MMA_TILE)
    return tiles * -(-ntot // MMA_TILE)


def mma_dtaps_split(rows: int, out_tiles: int):
    """(rows per chunk, chunks) for the tensor-core dtaps over ``rows`` rows
    with ``out_tiles`` blocks a chunk (``mma_dtaps_blocks``): as many chunks
    as keep the grid within one wave of ``MMA_TARGET_BLOCKS`` (at least one,
    at least 512 rows each), each a multiple of the 32-row K step."""
    want = max(1, min(MMA_TARGET_BLOCKS // out_tiles, -(-rows // 512)))
    kc = -(-rows // want)
    kc = -(-kc // MMA_K_STEP) * MMA_K_STEP
    return kc, -(-rows // kc)


def grid_dtaps_split(rows: int, cin: int, ntot: int):
    """(rows per chunk, chunks) of the grid convs' tensor-core dtaps (b, f)
    over ``rows`` rows into (7·C_in, ``ntot``): ``mma_dtaps_split`` over
    its blocks a chunk, on the NARROW tile where ``mma_narrow``."""
    return mma_dtaps_split(rows, mma_dtaps_blocks(cin, ntot, mma_narrow(cin)))


def operand_width(cin: int) -> int:
    """Channels of an operand row of the tensor-core GEMMs: C_in rounded up
    to 8 (16-byte rows in bf16)."""
    return -(-cin // 8) * 8


def _gemm_info(name: str, *flags: bool) -> dict:
    out = (ctypes.c_int * 4)()
    check(name, getattr(library(), name)(*map(int, flags), out))
    return dict(zip(("registers", "blocks_per_sm", "smem_bytes", "local_bytes"), out))


def mma_dtaps_info(pair: bool, fold: bool) -> dict:
    """Registers a thread, blocks an SM, dynamic shared memory and local
    memory (bytes; spills) of the tensor-core dtaps GEMM of n (``pair``) or
    d, with the fold or without, as the card's runtime reports them."""
    return _gemm_info("gn_up_pair_dtaps_info" if pair else "gn_up_dual_conv_dtaps_info", fold)


def grid_dtaps_info(std: bool, fold: bool, narrow: bool = False, split: bool = False) -> dict:
    """``mma_dtaps_info`` for the grid convs' tensor-core dtaps GEMM: of f
    (``std``), of m's stride-2 dtaps (``split``: its G rows from the parity
    phases) or b, with the fold or without, on the NARROW tile or the wide
    one."""
    name = ("gn_ico_conv_dtaps_info" if std else "gn_ds2s_dtaps_info" if split
            else "gn_phase_conv_dtaps_info")
    return _gemm_info(name, narrow, fold)


def mma_fwd_grid(rows: int, ntot: int):
    """(column tiles, row tiles) of the tensor-core forward
    (csrc/mma_conv_fwd.cuh) over ``rows`` output rows and ``ntot`` columns
    (both tap sets side by side): a block takes MMA_TILE of each, over 7
    taps of C_in in MMA_K_STEP-channel steps; its stats partials have one
    row a row tile."""
    return -(-ntot // MMA_TILE), -(-rows // MMA_TILE)


def packed_taps_shape(cin: int, ntot: int):
    """Shape of the tensor-core forward's packed taps: a row per tap and
    input channel (C_in rounded up to the K step, zero past C_in), a column
    per output column (rounded up to the tile, zero past ``ntot``)."""
    return 7 * -(-cin // MMA_K_STEP) * MMA_K_STEP, -(-ntot // MMA_TILE) * MMA_TILE


def mma_fwd_info(pair: bool, stats: bool) -> dict:
    """``mma_dtaps_info`` for the tensor-core forward GEMM of n (``pair``) or
    the up conv, with the stats epilogue or without."""
    return _gemm_info("gn_up_pair_fwd_info" if pair else "gn_up_dual_conv_fwd_info", stats)


def grid_fwd_info(std: bool, stats: bool) -> dict:
    """``mma_fwd_info`` for the grid convs' tensor-core forward GEMM: of the
    standard conv (``std``) or the phase conv, with the stats epilogue or
    without."""
    return _gemm_info("gn_ico_conv_fwd_info" if std else "gn_phase_conv_fwd_info", stats)


def ds2s_fwd_info(stats: bool) -> dict:
    """``grid_fwd_info`` for m's bf16 forward GEMM: the phase conv's at
    output phase 2 with the split store in its epilogue, with the stats
    epilogue or without."""
    return _gemm_info("gn_ds2s_fwd_info", stats)


def block_fwd_info(up: bool) -> dict:
    """``mma_dtaps_info`` for the merged blocks' bf16 cooperative kernel: o's
    (``up``) or p's."""
    return _gemm_info("gn_up_block_fwd_info" if up else "gn_dn_block_fwd_info")


def dx_packed_taps_shape(cin: int, ntot: int):
    """Shape of the tensor-core dx GEMMs' (a, c) packed taps, the tap sets
    transposed: a row per tap and cotangent column (``ntot`` rounded up to
    the K step, zero past it), a column per input channel (C_in rounded up
    to the tile, zero past it)."""
    return 7 * -(-ntot // MMA_K_STEP) * MMA_K_STEP, -(-cin // MMA_TILE) * MMA_TILE


def cot_operand_shape(B: int, rows: int, n_comb: int, ntot: int):
    """Shape of the dx GEMMs' cotangent operand: per sample its ``rows``
    cotangent rows (n_out·5hw) and ``n_comb`` combined rows, then one zero
    row; ``ntot`` columns rounded up to 8."""
    return B * (rows + n_comb) + 1, operand_width(ntot)


def up_bwd_info() -> dict:
    """``mma_dtaps_info`` for j's bf16 launch of both GEMMs (``mma_bwd``:
    d's dtaps tiles over the written cotangent and c's dx tiles)."""
    return _gemm_info("gn_up_dual_conv_bwd_info")


def phase_bwd_info(narrow: bool, act: bool) -> dict:
    """``mma_dtaps_info`` for i's bf16 launch of both GEMMs
    (``mma_bwd``: b's dtaps tiles over the written cotangent, on the
    NARROW tile or the wide one, and a's dx tiles, with the act epilogue or
    without)."""
    return _gemm_info("gn_phase_conv_bwd_info", narrow, act)


def std_bwd_info(narrow: bool, act: bool) -> dict:
    """``mma_dtaps_info`` for k's bf16 launch of both GEMMs (``mma_bwd``:
    f's dtaps tiles over the written cotangent, on the NARROW tile or the
    wide one, and f's dx tiles, with the act epilogue or without)."""
    return _gemm_info("gn_ico_conv_bwd_info", narrow, act)


def mma_dx_info(up: bool, act: bool = False, std: bool = False, split: bool = False,
                pair: bool = False) -> dict:
    """``mma_dtaps_info`` for the tensor-core dx GEMM of the up conv (c,
    ``up``; n's, ``up`` and ``pair``), the standard conv (f, ``std``), m
    (``split``: its cotangent written from the parity phases) or the phase
    conv (a), with the act epilogue or without."""
    if up:
        return _gemm_info("gn_up_pair_dx_info" if pair else "gn_up_dual_conv_dx_info")
    name = ("gn_ico_conv_dx_info" if std else "gn_ds2s_dx_info" if split
            else "gn_phase_conv_dx_info")
    return _gemm_info(name, act)


# n's bf16 dx ends in a pass over the level-s cells (csrc/up_pair.cu:
# pair_adjoint_pass) whose blocks take PAIR_ADJOINT_ROWS cells each and
# write one row of [d_mul1 | d_add1 | d_mul2] partials.
PAIR_ADJOINT_ROWS = 64


def pair_adjoint_blocks(B: int, h: int, w: int) -> int:
    """Partial rows of n's bf16 pair adjoint pass at the level-s (h, w) grid:
    one a PAIR_ADJOINT_ROWS cells of the B·5hw (``csrc/up_pair.cu:PA_ROWS``
    says the same)."""
    return -(-B * 5 * h * w // PAIR_ADJOINT_ROWS)


# The pair head's backward (csrc/pair_head.cu): a grid of at most
# HEAD_BWD_BLOCKS blocks (2 for each of the H100's 132 SMs), and at most one
# for each HEAD_CELLS_A_BLOCK cells (a bf16 block's step at C 64: 32 groups
# of 8 lanes), walks the cells in a grid-stride loop and writes one partial
# row a block.
HEAD_BWD_BLOCKS = 264
HEAD_CELLS_A_BLOCK = 32


def head_bwd_blocks(B: int, h: int, w: int) -> int:
    """Blocks of the pair head's backward at (B, h, w), one partial row of
    (C·F + F + 3·C) float32 each (``csrc/pair_head.cu:head_bwd_blocks``
    says the same)."""
    return max(1, min(HEAD_BWD_BLOCKS, -(-B * 5 * h * w // HEAD_CELLS_A_BLOCK)))


# The head+MSE forward (csrc/pair_head.cu): a block sums HEAD_MSE_CELLS cells
# of one sample into one float32 partial.
HEAD_MSE_CELLS = 64


def head_mse_parts(B: int, h: int, w: int) -> int:
    """Partials of the head+MSE forward at (B, h, w): ceil(5hw /
    HEAD_MSE_CELLS) a sample (``csrc/pair_head.cu:head_mse_parts`` says the
    same)."""
    return B * -(-5 * h * w // HEAD_MSE_CELLS)


# The merged blocks' bf16 cooperative kernel (csrc/mma_block_fwd.cuh) orders
# its blocks by SM with zeroed counters: MAX_SLOTS for the blocks' arrival
# order on an SM, then one for each of MAX_SM_IDS SM ids.
MAX_SLOTS = 8
MAX_SM_IDS = 1024


def scratch(n: int, device) -> torch.Tensor:
    """A float32 scratch buffer of n values for the partial sums."""
    return torch.empty(max(n, 1), dtype=torch.float32, device=device)


def merged_scratch(rows: int, cin: int, ntot: int, device):
    """(kc, n_chunks, dtaps partials, Σg partials) of a float32 merged
    backward kernel (i, j, k's SIMT tiles) whose dtaps reduce over ``rows``
    rows of g into (7·cin, ntot); in bf16 each takes its split route's
    dtaps split."""
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
    """A host array of device pointers (null for None), for the kernels'
    pointer-list arguments."""
    return (ctypes.c_void_p * len(tensors))(*[ptr(t) for t in tensors])


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
