#!/usr/bin/env python3
"""Phase times of the merged blocks' bf16 cooperative kernel (o, p) on one CUDA GPU.

    python3 scripts/torch_block_phases.py [--root DIR] [--reps N]

Copies ``DIR/geniconet_tpu_torch`` and ``DIR/chip_smoke.py`` (default: the
checkout this script is in) into ``DIR/build/block_phases/``, adds to that
copy's ``csrc/mma_block_fwd.cuh`` a ``%globaltimer`` stamp that block 0
takes at the kernel's start, after each of its six grid barriers and at its
end, and a C entry that reads the stamps back, builds the copy's kernels and
runs ``chip_smoke.py``'s bf16 o and p cases (s=5, B=36, every AE and VAE
site). Per case it prints the median over ``--reps`` calls of each phase's
time (pass A's operand and tap packs, pass A's GEMM, its sums, bn00's
affine, pass B's operand, pass B's GEMM, its sums as block 0 saw them) and,
from a ``torch.profiler`` trace, the device time of each kernel of the split
pair the block replaces (the first conv with stats; the affine and conv01
with stats). The stamps cost two global stores of block 0's thread 0; the
copy is not the program.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import shutil
import statistics
import sys
from pathlib import Path

PHASES = ("operand A + packs", "GEMM A", "sums A", "affine", "operand B", "GEMM B",
          "sums B (block 0)")


def instrument(csrc: Path):
    """The stamps and their reader, added to a copy of the kernel's sources."""
    p = csrc / "mma_block_fwd.cuh"
    s = p.read_text()
    head = "template <typename LoadA>\n__global__ void __launch_bounds__(fwd::NT, 2) " \
           "mma_two_pass_block(MmaTwoPass<LoadA> a) {"
    if s.count(head) != 1:
        raise SystemExit("torch_block_phases: mma_two_pass_block not found as expected")
    s = s.replace(head, '''static __device__ unsigned long long g_stamps[8];
__device__ __forceinline__ void stamp(int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[k] = t;
  }
}

''' + head + "\n  stamp(0);")
    start = s.index("mma_two_pass_block(MmaTwoPass<LoadA> a) {")
    end = s.index("\n}\n", start)
    body, n = s[start:end], [0]

    def bar(_):
        n[0] += 1
        return f"grid_barrier(a.bar);\n  stamp({n[0]});"

    body = re.sub(r"grid_barrier\(a\.bar\);", bar, body) + "\n  stamp(7);"
    if n[0] != 6:
        raise SystemExit(f"torch_block_phases: {n[0]} grid barriers, expected 6")
    s = s[:start] + body + s[end:]
    s = s.replace("}  // namespace gn\n", '''inline cudaError_t read_stamps(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}

}  // namespace gn
''')
    p.write_text(s)
    for f, name in (("up_block.cu", "gn_up_block_stamps"), ("dn_block.cu", "gn_dn_block_stamps")):
        q = csrc / f
        q.write_text(q.read_text() + f'\nextern "C" int {name}(unsigned long long* out) '
                                     '{ return gn::read_stamps(out); }\n')


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    copy = root / "build" / "block_phases"
    shutil.rmtree(copy, ignore_errors=True)
    copy.mkdir(parents=True)
    shutil.copytree(root / "geniconet_tpu_torch", copy / "geniconet_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in ("chip_smoke.py", "pyproject.toml"):
        shutil.copy(root / f, copy / f)
    instrument(copy / "geniconet_tpu_torch" / "csrc")
    sys.path.insert(0, str(copy))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_block_phases: needs a CUDA GPU")
    spec = importlib.util.spec_from_file_location("chip_smoke", copy / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from geniconet_tpu_torch.ops.kernels import build

    lib = build.library()
    for name in ("gn_up_block_stamps", "gn_dn_block_stamps"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, label, make, _ in cs.training_cases():
        if name not in ("up_block_fwd", "dn_block_fwd"):
            continue
        case = make(torch.bfloat16, gen)
        read = getattr(lib, "gn_up_block_stamps" if name == "up_block_fwd" else
                       "gn_dn_block_stamps")
        rows = []
        for _ in range(args.reps + 2):
            case.kernel()
            buf = (ctypes.c_ulonglong * 8)()
            build.check(name, read(buf))
            rows.append([(buf[k + 1] - buf[k]) / 1e3 for k in range(7)])
        med = [statistics.median(r[k] for r in rows[2:]) for k in range(7)]
        print(f"[phases] {name} {label}: " + ", ".join(f"{n} {v:.1f} us"
                                                      for n, v in zip(PHASES, med))
              + f"; total {sum(med):.1f} us [{card}]", flush=True)
        for tag, f in zip(("first", "second"), case.split):
            parts = cs.trace_kernels(f, per_launch=True)
            print(f"[split] {name} {label} {tag}: "
                  + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in sorted(parts.items()))
                  + f"; sum {sum(parts.values()) * 1e3:.1f} us [{card}]", flush=True)


if __name__ == "__main__":
    main()
