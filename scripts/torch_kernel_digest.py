#!/usr/bin/env python3
"""Digests of the tensor-core kernels' and the grid convs' dtaps outputs on one CUDA GPU.

    python3 scripts/torch_kernel_digest.py [--root DIR]

Runs, on seeded inputs at s=5 model widths (B=2), the bf16 and float32 up
conv forward (``up_dual_conv_fwd``, with stats) and dtaps (d,
``up_dual_conv_dtaps``), kernel n's forward and dtaps (``up_pair_fwd``,
``up_pair_dtaps``), each with and without the stats fold where it has one,
and the grid convs' dtaps (b, ``phase_conv_dtaps``, at conv_in, up2's
conv01 and down1's stride-2 conv; f, ``ico_conv_s2s_dtaps``, at down1's
conv01) and the grid convs' forward (``phase_conv_fwd`` at conv_in, up1's
and up2's conv01 and down1's stride-2 conv; ``ico_conv_s2s_fwd`` at
down1's conv01; with stats, and once without), and the input gradients
(a, ``phase_conv_dx``, at up2's conv01, down1's and down2's stride-2 conv;
c, ``up_dual_conv_dx``, at up1; f's, m's and n's dx at down1 / up1), and
the pair head's forwards and backwards (``pair_head_fwd``,
``pair_head_mse_fwd``; e, ``pair_head_bwd``; h, ``pair_head_mse_bwd``) at
the s=5 head, and the merged blocks (o, ``up_block_fwd``, at up1; p,
``dn_block_fwd``, at down1), and the merged up-conv backward (j,
``up_dual_conv_bwd``, at up1) and m's dtaps (``ds2s_dtaps``, at down1),
each with the fold and without, and the merged phase-conv backward (i,
``phase_conv_bwd``, at up2's conv01 and down1's stride-2 conv, with the
act, with the fold and without), and m's forward (``ds2s_fwd``, at down1
with the act and stats, at down2 without) and the merged standard-conv
backward (k, ``ico_conv_s2s_bwd``, at down1's and down2's conv01, with the
act, with the fold and without), and prints one line per call: ``digest <kernel> <dtype> <case>
<sha256 of the outputs' bytes>``. ``--root`` names the checkout whose
``geniconet_tpu_torch`` is imported (default: the one this script is in),
so the lines of two commits, each run in its own process, can be compared
with ``diff``: equal digests are bit-equal outputs.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_digest: needs a CUDA GPU")
    from geniconet_tpu_torch.ops.kernels import conv_kernel as ck
    from geniconet_tpu_torch.ops.kernels import phase_kernel as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    B = 2

    def rnd(gen, *shape, dt, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to("cuda", dt)

    def digest(out):
        h = hashlib.sha256()
        stack = [out]
        while stack:
            o = stack.pop(0)
            if isinstance(o, (tuple, list)):
                stack[:0] = list(o)
            elif o is not None:
                h.update(o.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    def line(kernel, dt, case, call):
        out = call()
        torch.cuda.synchronize()
        print(f"digest {kernel} {str(dt).split('.')[-1]} {case} {digest(out)}", flush=True)

    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(11)
        act = (torch.rand(128, generator=gen).add(0.5).to("cuda"),
               (0.3 * torch.randn(128, generator=gen)).to("cuda"))
        # the up conv at up1 (level-3 grid, 256 -> 2x128) and n at up2 (level-4 pair, 128 -> 2x64)
        x = rnd(gen, B, 5, 8, 16, 256, dt=dt)
        sets = [(rnd(gen, 7, 256, 128, dt=dt, scale=256**-0.5), rnd(gen, 128, dt=dt))
                for _ in range(2)]
        line("up_dual_conv_fwd", dt, "up1+stats",
             lambda: pk.up_dual_conv_fwd(x, sets, "average", True))
        g = [[rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)] for _ in range(2)]
        y = [[rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)] for _ in range(2)]
        gs = [rnd(gen, 2, 128, dt=torch.float32, scale=1e-3) for _ in range(2)]
        for fold in (True, False):
            fk = dict(y_groups=y, gs_list=gs) if fold else {}
            line("up_dual_conv_dtaps", dt, f"up1 fold={fold}",
                 lambda: pk.up_dual_conv_dtaps(x, g, "average", **fk))
        b0 = [rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)]
        y10 = [rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)]
        aff = [*act, *act]
        psets = [(rnd(gen, 7, 128, 64, dt=dt, scale=128**-0.5), rnd(gen, 64, dt=dt))
                 for _ in range(2)]
        line("up_pair_fwd", dt, "up2+stats",
             lambda: pk.up_pair_fwd(b0, y10, aff, psets, "average", True))
        g = [[rnd(gen, B, 5, 16, 32, 64, dt=dt) for _ in range(4)] for _ in range(2)]
        y = [[rnd(gen, B, 5, 16, 32, 64, dt=dt) for _ in range(4)] for _ in range(2)]
        gs = [rnd(gen, 2, 64, dt=torch.float32, scale=1e-3) for _ in range(2)]
        for fold in (True, False):
            fk = dict(y_groups=y, gs_list=gs) if fold else {}
            line("up_pair_dtaps", dt, f"up2 fold={fold}",
                 lambda: pk.up_pair_dtaps(b0, y10, aff, g, "average", **fk))
        # b at conv_in (3 -> 64, Σg), up2's conv01 (64 -> 64, act) and down1's
        # stride-2 conv (128 -> 2x256, act); f at down1's conv01 (256, act)
        for case, (h, w, cin, cout, n_sets, out_phases, a) in {
                "conv_in": (16, 32, 3, 64, 1, (0, 1, 2, 3), None),
                "up2_conv01": (16, 32, 64, 64, 1, (0, 1, 2, 3), act),
                "down1_s2": (8, 16, 128, 256, 2, (2,), act)}.items():
            a = None if a is None else (a[0][:cin].contiguous(), a[1][:cin].contiguous())
            ph = [rnd(gen, B, 5, h, w, cin, dt=dt) for _ in range(4)]
            g = [[rnd(gen, B, 5, h, w, cout, dt=dt) for _ in out_phases] for _ in range(n_sets)]
            y = [[rnd(gen, B, 5, h, w, cout, dt=dt) for _ in out_phases] for _ in range(n_sets)]
            gs = [rnd(gen, 2, cout, dt=torch.float32, scale=1e-3) for _ in range(n_sets)]
            line("phase_conv_dtaps", dt, case,
                 lambda: pk.phase_conv_dtaps(ph, g, [(7, cin, cout)] * n_sets, "average",
                                             out_phases, a, y, gs, emit_gsum=True))
        x = rnd(gen, B, 5, 8, 16, 256, dt=dt)
        g, y = rnd(gen, B, 5, 8, 16, 256, dt=dt), rnd(gen, B, 5, 8, 16, 256, dt=dt)
        gs = rnd(gen, 2, 256, dt=torch.float32, scale=1e-3)
        a256 = (torch.rand(256, generator=gen).add(0.5).to("cuda"),
                (0.3 * torch.randn(256, generator=gen)).to("cuda"))
        line("ico_conv_s2s_dtaps", dt, "down1_conv01",
             lambda: ck.ico_conv_s2s_dtaps(x, g, "average", a256, y, gs))
    for dt in (torch.bfloat16, torch.float32):
        # the grid convs' forward, after the lines above (a generator of its
        # own, so theirs stay as they were)
        gen = torch.Generator().manual_seed(12)
        for case, (h, w, cin, cout, n_sets, out_phases, with_act, stats) in {
                "conv_in+stats": (16, 32, 3, 64, 1, (0, 1, 2, 3), False, True),
                "up1_conv01+stats": (8, 16, 128, 128, 1, (0, 1, 2, 3), True, True),
                "up2_conv01+stats": (16, 32, 64, 64, 1, (0, 1, 2, 3), True, True),
                "up2_conv01": (16, 32, 64, 64, 1, (0, 1, 2, 3), True, False),
                "down1_s2+stats": (8, 16, 128, 256, 2, (2,), True, True)}.items():
            a = ((torch.rand(cin, generator=gen).add(0.5).to("cuda"),
                  (0.3 * torch.randn(cin, generator=gen)).to("cuda")) if with_act else None)
            ph = [rnd(gen, B, 5, h, w, cin, dt=dt) for _ in range(4)]
            sets = [(rnd(gen, 7, cin, cout, dt=dt, scale=cin**-0.5), rnd(gen, cout, dt=dt))
                    for _ in range(n_sets)]
            line("phase_conv_fwd", dt, case,
                 lambda: pk.phase_conv_fwd(ph, sets, "average", out_phases, a, stats))
        x = rnd(gen, B, 5, 8, 16, 256, dt=dt)
        t, b = rnd(gen, 7, 256, 256, dt=dt, scale=256**-0.5), rnd(gen, 256, dt=dt)
        a256 = (torch.rand(256, generator=gen).add(0.5).to("cuda"),
                (0.3 * torch.randn(256, generator=gen)).to("cuda"))
        line("ico_conv_s2s_fwd", dt, "down1_conv01+stats",
             lambda: ck.ico_conv_s2s_fwd(x, t, b, "average", a256, True))
    for dt in (torch.bfloat16, torch.float32):
        # the SIMT and tensor-core input gradients, after the lines above (a
        # generator of their own): a (phase_conv_dx) at up2's conv01 and
        # down1's stride-2 conv, with the act, and at down2's without it; c
        # (up_dual_conv_dx) at up1; f, m and n's dx at down1
        gen = torch.Generator().manual_seed(13)
        for case, (h, w, cin, cout, n_sets, out_phases, with_act) in {
                "up2_conv01": (16, 32, 64, 64, 1, (0, 1, 2, 3), True),
                "down1_s2": (8, 16, 128, 256, 2, (2,), True),
                "down2_s2_no_act": (4, 8, 256, 256, 2, (2,), False)}.items():
            a = ((torch.rand(cin, generator=gen).add(0.5).to("cuda"),
                  (0.3 * torch.randn(cin, generator=gen)).to("cuda")) if with_act else None)
            ph = [rnd(gen, B, 5, h, w, cin, dt=dt) for _ in range(4)]
            sets = [(rnd(gen, 7, cin, cout, dt=dt, scale=cin**-0.5), None) for _ in range(n_sets)]
            g = [[rnd(gen, B, 5, h, w, cout, dt=dt) for _ in out_phases] for _ in range(n_sets)]
            y = [[rnd(gen, B, 5, h, w, cout, dt=dt) for _ in out_phases] for _ in range(n_sets)]
            gs = [rnd(gen, 2, cout, dt=torch.float32, scale=1e-3) for _ in range(n_sets)]
            line("phase_conv_dx", dt, case,
                 lambda: pk.phase_conv_dx(g, sets, "average", out_phases, cin, dt, a,
                                          ph if a else None, y, gs))
        sets = [(rnd(gen, 7, 256, 128, dt=dt, scale=256**-0.5), None) for _ in range(2)]
        g = [[rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)] for _ in range(2)]
        y = [[rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)] for _ in range(2)]
        gs = [rnd(gen, 2, 128, dt=torch.float32, scale=1e-3) for _ in range(2)]
        line("up_dual_conv_dx", dt, "up1",
             lambda: pk.up_dual_conv_dx(g, sets, "average", dt, y, gs, True))
        x, g, y = (rnd(gen, B, 5, 8, 16, 256, dt=dt) for _ in range(3))
        t = rnd(gen, 7, 256, 256, dt=dt, scale=256**-0.5)
        gs = rnd(gen, 2, 256, dt=torch.float32, scale=1e-3)
        a256 = (torch.rand(256, generator=gen).add(0.5).to("cuda"),
                (0.3 * torch.randn(256, generator=gen)).to("cuda"))
        line("ico_conv_s2s_dx", dt, "down1_conv01",
             lambda: ck.ico_conv_s2s_dx(g, t, "average", dt, a256, x, y, gs, True))
        ph = [rnd(gen, B, 5, 16, 32, 128, dt=dt) for _ in range(4)]
        msets = [(rnd(gen, 7, 128, 256, dt=dt, scale=128**-0.5), None) for _ in range(2)]
        g = [[rnd(gen, B, 5, 8, 16, 256, dt=dt) for _ in range(4)] for _ in range(2)]
        y = [[rnd(gen, B, 5, 8, 16, 256, dt=dt) for _ in range(4)] for _ in range(2)]
        gs = [rnd(gen, 2, 256, dt=torch.float32, scale=1e-3) for _ in range(2)]
        line("ds2s_dx", dt, "down1",
             lambda: pk.ds2s_dx(g, msets, "average", 128, dt, None, None, y_groups=y,
                                gs_list=gs))
        b0 = [rnd(gen, B, 5, 4, 8, 256, dt=dt) for _ in range(4)]
        y10 = [rnd(gen, B, 5, 4, 8, 256, dt=dt) for _ in range(4)]
        aff = [a256[0], a256[1], a256[0], a256[1]]
        g = [[rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)] for _ in range(2)]
        line("up_pair_dx", dt, "up1",
             lambda: pk.up_pair_dx(g, b0, y10, aff, sets, "average", emit_gsum=True))
    for dt in (torch.bfloat16, torch.float32):
        # the pair head at the s=5 head (the level-4 phases, C 64, F 3),
        # after the lines above (a generator of its own): its forwards and
        # its backwards e (given g) and h (g from the target)
        gen = torch.Generator().manual_seed(14)
        b0 = [rnd(gen, B, 5, 16, 32, 64, dt=dt) for _ in range(4)]
        y10 = [rnd(gen, B, 5, 16, 32, 64, dt=dt) for _ in range(4)]
        aff = [(torch.rand(64, generator=gen).add(0.5)).to("cuda"),
               (0.3 * torch.randn(64, generator=gen)).to("cuda"),
               (torch.rand(64, generator=gen).add(0.5)).to("cuda"),
               (0.3 * torch.randn(64, generator=gen)).to("cuda")]
        W, bias = rnd(gen, 64, 3, dt=dt, scale=0.125), rnd(gen, 3, dt=dt, scale=0.1)
        tpack = torch.rand(B, 5, 16, 32, 12, generator=gen).mul(2).sub(1).to("cuda")
        tpoles = torch.rand(B, 6, generator=gen).mul(2).sub(1).to("cuda")
        g = tuple(rnd(gen, B, 5, 16, 32, 3, dt=torch.float32) for _ in range(4))
        gb = rnd(gen, B, dt=torch.float32)
        line("pair_head_fwd", dt, "head", lambda: pk.pair_head_fwd(b0, y10, aff, W, bias))
        line("pair_head_mse_fwd", dt, "head",
             lambda: pk.pair_head_mse_fwd(b0, y10, aff, W, bias, tpack, tpoles))
        line("pair_head_bwd", dt, "head", lambda: pk.pair_head_bwd(g, b0, y10, aff, W, bias))
        line("pair_head_mse_bwd", dt, "head",
             lambda: pk.pair_head_mse_bwd(gb, b0, y10, aff, W, bias, tpack, tpoles))
    for dt in (torch.bfloat16, torch.float32):
        # the merged blocks, after the lines above (a generator of their
        # own): o (up_block_fwd) at up1, p (dn_block_fwd) at down1 with the
        # pending act; every output (b0, y10, y00, s00, s01, s10, mul00, add00)
        gen = torch.Generator().manual_seed(15)
        x = rnd(gen, B, 5, 8, 16, 256, dt=dt)
        sets = [(rnd(gen, 7, a, c, dt=dt, scale=a**-0.5), rnd(gen, c, dt=dt, scale=0.1))
                for a, c in ((256, 128), (256, 128), (128, 128))]
        gamma = torch.rand(128, generator=gen).add(0.5).to("cuda")
        beta = (0.3 * torch.randn(128, generator=gen)).to("cuda")
        line("up_block_fwd", dt, "up1", lambda: pk.up_block_fwd(x, sets, gamma, beta))
        ph = [rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)]
        sets = [(rnd(gen, 7, a, c, dt=dt, scale=a**-0.5), rnd(gen, c, dt=dt, scale=0.1))
                for a, c in ((128, 256), (128, 256), (256, 256))]
        gamma = torch.rand(256, generator=gen).add(0.5).to("cuda")
        beta = (0.3 * torch.randn(256, generator=gen)).to("cuda")
        a128 = (torch.rand(128, generator=gen).add(0.5).to("cuda"),
                (0.3 * torch.randn(128, generator=gen)).to("cuda"))
        line("dn_block_fwd", dt, "down1",
             lambda: pk.dn_block_fwd(ph, sets, gamma, beta, a128))
    for dt in (torch.bfloat16, torch.float32):
        # the merged up-conv backward (j, up_dual_conv_bwd) at up1 and m's
        # dtaps (ds2s_dtaps) at down1 with the pending act, each with the
        # fold and without, after the lines above (a generator of their own)
        gen = torch.Generator().manual_seed(16)
        x = rnd(gen, B, 5, 8, 16, 256, dt=dt)
        sets = [(rnd(gen, 7, 256, 128, dt=dt, scale=256**-0.5), None) for _ in range(2)]
        g = [[rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)] for _ in range(2)]
        y = [[rnd(gen, B, 5, 8, 16, 128, dt=dt) for _ in range(4)] for _ in range(2)]
        gs = [rnd(gen, 2, 128, dt=torch.float32, scale=1e-3) for _ in range(2)]
        for fold in (True, False):
            fk = dict(y_groups=y, gs_list=gs) if fold else {}
            line("up_dual_conv_bwd", dt, f"up1 fold={fold}",
                 lambda: pk.up_dual_conv_bwd(x, g, sets, "average", **fk))
        ph = [rnd(gen, B, 5, 16, 32, 128, dt=dt) for _ in range(4)]
        a128 = (torch.rand(128, generator=gen).add(0.5).to("cuda"),
                (0.3 * torch.randn(128, generator=gen)).to("cuda"))
        g = [[rnd(gen, B, 5, 8, 16, 256, dt=dt) for _ in range(4)] for _ in range(2)]
        y = [[rnd(gen, B, 5, 8, 16, 256, dt=dt) for _ in range(4)] for _ in range(2)]
        gs = [rnd(gen, 2, 256, dt=torch.float32, scale=1e-3) for _ in range(2)]
        for fold in (True, False):
            fk = dict(y_groups=y, gs_list=gs) if fold else {}
            line("ds2s_dtaps", dt, f"down1 fold={fold}",
                 lambda: pk.ds2s_dtaps(ph, g, [(7, 128, 256)] * 2, "average", a128, **fk,
                                       emit_gsum=True))
    for dt in (torch.bfloat16, torch.float32):
        # the merged phase-conv backward (i, phase_conv_bwd) at up2's conv01
        # (C_in 64) and down1's stride-2 conv, with the pending act, each
        # with the fold and without, after the lines above (a generator of
        # their own)
        gen = torch.Generator().manual_seed(17)
        for case, (h, w, cin, cout, n_sets, out_phases) in {
                "up2_conv01": (16, 32, 64, 64, 1, (0, 1, 2, 3)),
                "down1_s2": (8, 16, 128, 256, 2, (2,))}.items():
            a = (torch.rand(cin, generator=gen).add(0.5).to("cuda"),
                 (0.3 * torch.randn(cin, generator=gen)).to("cuda"))
            ph = [rnd(gen, B, 5, h, w, cin, dt=dt) for _ in range(4)]
            sets = [(rnd(gen, 7, cin, cout, dt=dt, scale=cin**-0.5), None) for _ in range(n_sets)]
            g = [[rnd(gen, B, 5, h, w, cout, dt=dt) for _ in out_phases] for _ in range(n_sets)]
            y = [[rnd(gen, B, 5, h, w, cout, dt=dt) for _ in out_phases] for _ in range(n_sets)]
            gs = [rnd(gen, 2, cout, dt=torch.float32, scale=1e-3) for _ in range(n_sets)]
            for fold in (True, False):
                line("phase_conv_bwd", dt, f"{case} fold={fold}",
                     lambda: pk.phase_conv_bwd(ph, g, y if fold else None, gs if fold else None,
                                               sets, "average", out_phases, a, fold, dt))
    for dt in (torch.bfloat16, torch.float32):
        # m's forward (ds2s_fwd) at down1 with the pending act and stats and
        # at down2 without either, and the merged standard-conv backward (k,
        # ico_conv_s2s_bwd) at down1's and down2's conv01 with the act, each
        # with the fold and without, after the lines above (a generator of
        # their own)
        gen = torch.Generator().manual_seed(18)
        a128 = (torch.rand(128, generator=gen).add(0.5).to("cuda"),
                (0.3 * torch.randn(128, generator=gen)).to("cuda"))
        for case, (h, w, cin, cout, a, stats) in {
                "down1+stats": (8, 16, 128, 256, a128, True),
                "down2_no_act": (4, 8, 256, 256, None, False)}.items():
            ph = [rnd(gen, B, 5, h, w, cin, dt=dt) for _ in range(4)]
            sets = [(rnd(gen, 7, cin, cout, dt=dt, scale=cin**-0.5), rnd(gen, cout, dt=dt))
                    for _ in range(2)]
            line("ds2s_fwd", dt, case, lambda: pk.ds2s_fwd(ph, sets, "average", a, stats))
        for case, (h, w) in {"down1_conv01": (8, 16), "down2_conv01": (4, 8)}.items():
            x, g, y = (rnd(gen, B, 5, h, w, 256, dt=dt) for _ in range(3))
            t = rnd(gen, 7, 256, 256, dt=dt, scale=256**-0.5)
            gs = rnd(gen, 2, 256, dt=torch.float32, scale=1e-3)
            a256 = (torch.rand(256, generator=gen).add(0.5).to("cuda"),
                    (0.3 * torch.randn(256, generator=gen)).to("cuda"))
            for fold in (True, False):
                line("ico_conv_s2s_bwd", dt, f"{case} fold={fold}",
                     lambda: ck.ico_conv_s2s_bwd(x, g, t, y if fold else None,
                                                 gs if fold else None, "average", a256, fold,
                                                 dt))


if __name__ == "__main__":
    main()
