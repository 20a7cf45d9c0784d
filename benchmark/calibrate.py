"""The readings that each limit of ``correct`` is set from. Not part of a
benchmark run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For every seed, in one process and at the cell's own sizes: the numbers a
run computes for the program (a training cell's checked steps, a sample of
a reconstruction cell's meshes, against the float32 reference); for every
control seed, the same numbers for the control, the reference put in the
program's place in 8-bit floats (``reference/quant.py``), and for a
training cell for the fault of half of each batch left out (the reference,
the mean taken over the first half). A training state left unchanged reads
1 by the measure and needs no run. One JSON line per seed and kind, then
the summary: the largest reading of the program, the smallest of each
control and fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import checks, data, spec, weights  # noqa: E402
from benchmark.drivers import train as train_driver  # noqa: E402
from benchmark.drivers.common import Seeds, free, program_config  # noqa: E402
from benchmark.reference import loss as ref_loss  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference import quant  # noqa: E402


def training(cell, seed: int, control: bool, dev) -> list[dict]:
    seeds = Seeds.of(seed)
    st = train_driver.setup(cell, seeds, dev, warm=False)
    batches, eps = train_driver.reference_inputs(cell, seeds, st.pool_x, st.pool_y, dev)
    prog, params0 = train_driver.checked(st), st.params0
    del st
    free(dev)
    ref = train_driver.followed(cell, params0, batches, eps)
    out = [{"kind": "program", **train_driver.compare(prog, ref),
            "worst": checks.worst_leaves(prog["grad1"], ref["grad1"], prog["delta"],
                                         ref["delta"])}]
    if control:
        ctl = train_driver.followed(cell, params0, batches, eps, q=quant.fp8)
        out.append({"kind": "control_fp8", **train_driver.compare(ctl, ref)})
        half = [(x[: len(x) // 2], y[: len(y) // 2]) for x, y in batches]
        half_eps = None if eps is None else [e[: len(e) // 2] for e in eps]
        h = train_driver.followed(cell, params0, half, half_eps)
        out.append({"kind": "fault_half_batch", **train_driver.compare(h, ref)})
    return out


def reconstruction(cell, seed: int, control: bool, dev, sample: int) -> list[dict]:
    """Every mesh of one pass in the window's batches; the number over a
    seeded sample of ``sample`` meshes, as a run keeps about that many."""
    from geniconet_tpu_torch.bridge import state_dict_to_flax
    from geniconet_tpu_torch.eval.test_driver import reconstruct
    from geniconet_tpu_torch.train.trainer import Trainer

    t, c = cell.traffic, cell.config
    s, B, N = t["subdivisions"], t["batch_size"], t["pool"]
    seeds = Seeds.of(seed)
    grids = data.grids(data.vertices(s, N, seeds.data, dev), s)
    params0 = weights.running_stats(c, weights.make(c, seeds.weights, dev, random_stats=True),
                                    grids[:B], s)
    pool = grids.cpu().numpy()
    del grids
    trainer = Trainer(program_config(cell), device=dev)
    trainer.init_state(state_dict_to_flax(params0), seed=seeds.trainer)
    model = trainer.model.eval()
    with torch.no_grad():
        prog = torch.cat([reconstruct(model, torch.as_tensor(pool[i : i + B], device=dev)).cpu()
                          for i in range(0, N, B)])
    del trainer, model
    free(dev)
    pick = torch.randperm(N, generator=torch.Generator().manual_seed(seeds.sample))[:sample]
    pick = pick.sort().values

    def ref_of(q):
        out = []
        with torch.no_grad(), ref_model.exact_float32():
            for i in range(0, len(pick), B):
                x = torch.as_tensor(pool[pick[i : i + B].numpy()], device=dev)
                out.append(ref_loss.grid_to_vertices(ref_model.autoencoder(params0, x, s, False, q),
                                                     s).cpu())
        return torch.cat(out)

    ref = ref_of(ref_model.identity)
    out = [{"kind": "program", **checks.reconstruction(prog[pick], ref)}]
    if control:
        out.append({"kind": "control_fp8", **checks.reconstruction(ref_of(quant.fp8), ref)})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma list")
    p.add_argument("--control-seeds", default="", help="comma list")
    p.add_argument("--sample", type=int, default=60, help="meshes a reconstruction run keeps")
    a = p.parse_args(argv)
    cell = spec.cell(spec.load(ROOT), a.workload, ROOT)
    dev = torch.device("cuda")
    controls = {int(x) for x in a.control_seeds.split(",") if x}
    rows = []
    for seed in [int(x) for x in a.seeds.split(",")]:
        if cell.traffic["kind"] == "train":
            got = training(cell, seed, seed in controls, dev)
        else:
            got = reconstruction(cell, seed, seed in controls, dev, a.sample)
        for r in got:
            r["seed"] = seed
            print(json.dumps(r), flush=True)
            rows.append(r)
        free(dev)
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        mine = [r for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[k] for r in mine) for k in mine[0]
                         if k not in ("kind", "seed", "worst")}
    print(json.dumps({"workload": a.workload, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
