"""``chip_smoke.py`` and the port off the card: the script refuses to run
without a CUDA device; neither it nor any module of ``geniconet_tpu_torch``
(the CLI, the checkpoint codec and the logger included) imports JAX, flax,
msgpack or the JAX package; the profile arithmetic is right."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


PORT_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / "geniconet_tpu_torch").rglob("*.py"))


def test_refuses_without_a_card_and_imports_no_jax():
    """In a fresh interpreter where importing jax, jaxlib, flax, msgpack or
    geniconet_tpu fails: every module of the port imports (the eval, the
    .pt import and the data tools too), and the script runs to its refusal."""
    assert {"geniconet_tpu_torch.ops.point_mesh", "geniconet_tpu_torch.eval.test_driver",
            "geniconet_tpu_torch.train.pt_import", "geniconet_tpu_torch.train.summary",
            "geniconet_tpu_torch.data.generate", "geniconet_tpu_torch.app.server",
            "geniconet_tpu_torch.app.state"} <= set(PORT_MODULES)
    code = (
        "import importlib, importlib.abc, runpy, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack', 'geniconet_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert "imported" in out.stdout, out.stderr
    assert "is_available() is False" in out.stderr, out.stderr
    assert '"ok"' not in out.stdout


def _import_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    return {name.split(".")[0] for name in names}


def test_imports_only_torch_and_the_port():
    """No import anywhere in the script or in any file of the port, nested
    ones included, names JAX, flax, msgpack or the JAX package."""
    assert "geniconet_tpu_torch" in _import_tops(REPO / "chip_smoke.py")
    files = [REPO / "chip_smoke.py", *sorted((REPO / "geniconet_tpu_torch").rglob("*.py"))]
    assert len(files) > 30
    assert {"cli.py", "checkpoint.py", "logging.py", "point_mesh.py", "test_driver.py",
            "pt_import.py", "generate.py", "summary.py", "server.py",
            "state.py"} <= {p.name for p in files}
    for path in files:
        tops = _import_tops(path)
        assert not tops & {"jax", "jaxlib", "flax", "msgpack", "geniconet_tpu"}, (path,
                                                                                  sorted(tops))


@pytest.mark.parametrize("intervals, want_ms", [
    ([(0, 10), (5, 20), (30, 40)], 0.030),   # overlap merged, gap left out
    ([(30, 40), (0, 10)], 0.020),            # any order
    ([(0, 50), (10, 20), (20, 30)], 0.050),  # nested
])
def test_busy_time_is_the_union_of_device_events(intervals, want_ms):
    assert chip_smoke.busy_ms(intervals) == pytest.approx(want_ms)


@pytest.mark.parametrize("event, group", [
    ({"cat": "kernel", "name": "void gn::conv_gemm<__nv_bfloat16, gn::UpLoad<__nv_bfloat16> >"},
     "conv_gemm<bf16, UpLoad>"),
    ({"cat": "kernel", "name": "void gn::conv_gemm<float, gn::GridLoad<float> >"},
     "conv_gemm<fp32, GridLoad>"),
    ({"cat": "kernel", "name": "void gn::pair_head_kernel<float>"}, "pair_head_kernel"),
    ({"cat": "kernel", "name": "void (anonymous namespace)::phmse_bwd_kernel<__nv_bfloat16, 1, "
                               "3>((anonymous namespace)::HeadBwdArgs<__nv_bfloat16>)"},
     "phmse_bwd (head+MSE bwd, kernel h)"),
    ({"cat": "kernel", "name": "void phmse_fwd_kernel<__nv_bfloat16>(HeadIn<__nv_bfloat16>)"},
     "phmse_fwd (head+MSE fwd, kernel g)"),
    ({"cat": "kernel", "name": "void phmse_poles_kernel<float>(HeadIn<float>)"},
     "phmse_poles (pole pass, g and h)"),
    ({"cat": "kernel", "name": "void (anonymous namespace)::phead_bwd_kernel<__nv_bfloat16>("
                               "(anonymous namespace)::HeadIn<__nv_bfloat16>)"},
     "phead_bwd (head bwd, kernel e)"),
    ({"cat": "kernel", "name": "void gn::dx_gemm<__nv_bfloat16>(gn::GLoad<__nv_bfloat16>)"},
     "dx_gemm<bf16>"),
    # f's bf16 dx: the one GEMM template's StdGrid instance, its cotangent
    # pass and transposed tap pack
    ({"cat": "kernel", "name": "void gn::mma_conv<gn::StdGrid, gn::DxEpi<true> >"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::DxEpi<true>, int)"},
     "mma_conv_dx<bf16> (f)"),
    ({"cat": "kernel", "name": "void gn::cot_operand_pass<gn::StdGrid>"
                               "(gn::GLoad<__nv_bfloat16, false>, gn::CombRows)"},
     "cot_operand_pass<bf16> (f)"),
    ({"cat": "kernel", "name": "void gn::pack_taps_t<__nv_bfloat16, gn::StdGrid>"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*)"},
     "pack_taps (f)"),
    ({"cat": "kernel", "name": "void gn::dtaps_gemm<float, gn::UpLoad<float> >"},
     "dtaps_gemm<fp32, UpLoad>"),
    ({"cat": "kernel", "name": "void gn::sum_rows<gn::SplitOut>"},
     "sum_rows + colsum (cross-block sums)"),
    ({"cat": "kernel", "name": "void gn::sum_chunks<gn::SplitOut>"},
     "sum_rows + colsum (cross-block sums)"),
    # the bf16 dtaps of d and n: their own rows, whatever else the name holds
    ({"cat": "kernel", "name": "void gn::mma_dtaps<gn::GridCells<__nv_bfloat16>, true>"
                               "(gn::OperandRows, gn::GLoad<__nv_bfloat16, false>)"},
     "mma_dtaps<bf16> (d)"),
    ({"cat": "kernel", "name": "void gn::mma_dtaps<gn::PairCells<__nv_bfloat16>, false>"
                               "(gn::OperandRows, gn::GLoad<__nv_bfloat16, false>)"},
     "mma_dtaps<bf16> (n)"),
    ({"cat": "kernel", "name": "void gn::up_operand_pass<__nv_bfloat16, "
                               "gn::GridCells<__nv_bfloat16> >(gn::UpLoad<__nv_bfloat16>)"},
     "up_operand_pass<bf16> (d)"),
    ({"cat": "kernel", "name": "void gn::up_operand_pass<float, gn::PairCells<float> >"
                               "(gn::UpLoad<float, gn::GridCells<float> >)"},
     "up_operand_pass<fp32> (n)"),
    ({"cat": "kernel", "name": "void gn::pair_join_pass<__nv_bfloat16>"
                               "(gn::PairCells<__nv_bfloat16>, __nv_bfloat16*)"},
     "up_operand_pass<bf16> (n)"),
    # the bf16 dtaps of the grid convs, b and f: their GEMM's rows (the
    # NARROW tile's too) and their operand passes
    ({"cat": "kernel", "name": "void gn::mma_dtaps<gn::PhaseGrid, true, true>"
                               "(gn::OperandRows, gn::GLoad<__nv_bfloat16, false>, int)"},
     "mma_dtaps<bf16> (b)"),
    ({"cat": "kernel", "name": "void gn::mma_dtaps<gn::StdGrid, false, false>"
                               "(gn::OperandRows, gn::GLoad<__nv_bfloat16, false>, int)"},
     "mma_dtaps<bf16> (f)"),
    ({"cat": "kernel", "name": "void gn::grid_operand_pass<__nv_bfloat16, gn::PhaseGrid>"
                               "(gn::GridLoad<__nv_bfloat16, false>, __nv_bfloat16*, int)"},
     "grid_operand_pass<bf16> (b)"),
    ({"cat": "kernel", "name": "void gn::grid_operand_pass<__nv_bfloat16, gn::StdGrid>"
                               "(gn::GridLoad<__nv_bfloat16, false>, __nv_bfloat16*, int)"},
     "grid_operand_pass<bf16> (f)"),
    ({"cat": "kernel", "name": "void gn::sum_rows<(anonymous namespace)::CastOut<__nv_bfloat16> >"
                               "(float const*, int, long long)"},
     "sum_rows + colsum (cross-block sums)"),
    # the bf16 forward of the up conv and of n: the GEMM's rows and the tap pack
    ({"cat": "kernel", "name": "void gn::mma_conv_fwd<gn::GridCells<__nv_bfloat16>, true>"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::FwdOut, int)"},
     "mma_conv_fwd<bf16> (up conv)"),
    ({"cat": "kernel", "name": "void gn::mma_conv_fwd<gn::PairCells<__nv_bfloat16>, false>"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::FwdOut, int)"},
     "mma_conv_fwd<bf16> (n)"),
    ({"cat": "kernel", "name": "void gn::pack_taps<__nv_bfloat16>(__nv_bfloat16 const*, "
                               "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, "
                               "long long)"},
     "pack_taps (up conv, n)"),
    # the bf16 forward of the grid convs: the GEMM's and the tap pack's rows
    ({"cat": "kernel", "name": "void gn::mma_conv_fwd<gn::PhaseGrid, true>"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::FwdOut, int)"},
     "mma_conv_fwd<bf16> (b)"),
    ({"cat": "kernel", "name": "void gn::mma_conv_fwd<gn::StdGrid, false>"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::FwdOut, int)"},
     "mma_conv_fwd<bf16> (f)"),
    ({"cat": "kernel", "name": "void gn::pack_taps<__nv_bfloat16, gn::PhaseGrid>"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
                               "int, int, int, int, int, long long)"},
     "pack_taps (b)"),
    ({"cat": "kernel", "name": "void gn::pack_taps<__nv_bfloat16, gn::GridCells<__nv_bfloat16> >"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
                               "int, int, int, int, int, long long)"},
     "pack_taps (up conv, n)"),
    ({"cat": "kernel", "name": "void gn::conv_gemm<__nv_bfloat16, gn::GridLoad<__nv_bfloat16, "
                               "false>, true>"},
     "conv_gemm<bf16, GridLoad, split> (m)"),
    # the one GEMM template's forward (FwdEpi) and dx (a: DxEpi, c: DuEpi)
    # instantiations, a's and c's cotangent passes, tap packs and c's
    # upsample adjoint; the SIMT dx tiles of m, n and the float32 a, c, f
    ({"cat": "kernel", "name": "void gn::mma_conv<gn::PhaseGrid, gn::FwdEpi<true> >"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::FwdEpi<true>, int)"},
     "mma_conv_fwd<bf16> (b)"),
    ({"cat": "kernel", "name": "void gn::mma_conv<gn::GridCells<__nv_bfloat16>, "
                               "gn::FwdEpi<false> >(gn::OperandRows)"},
     "mma_conv_fwd<bf16> (up conv)"),
    ({"cat": "kernel", "name": "void gn::mma_conv<gn::PhaseGrid, gn::DxEpi<true> >"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::DxEpi<true>, int)"},
     "mma_conv_dx<bf16> (a)"),
    ({"cat": "kernel", "name": "void gn::mma_conv<gn::GridCells<__nv_bfloat16>, gn::DuEpi>"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::DuEpi, int)"},
     "mma_conv_dx<bf16> (c)"),
    ({"cat": "kernel", "name": "void gn::cot_operand_pass<gn::PhaseGrid>"
                               "(gn::GLoad<__nv_bfloat16, false>, gn::CombRows)"},
     "cot_operand_pass<bf16> (a)"),
    ({"cat": "kernel", "name": "void gn::cot_operand_pass<gn::GridCells<__nv_bfloat16> >"
                               "(gn::GLoad<__nv_bfloat16, false>, gn::CombRows)"},
     "cot_operand_pass<bf16> (c)"),
    ({"cat": "kernel", "name": "void gn::pack_taps_t<__nv_bfloat16, gn::PhaseGrid>"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*)"},
     "pack_taps (a)"),
    ({"cat": "kernel", "name": "void gn::pack_taps_t<__nv_bfloat16, gn::GridCells<"
                               "__nv_bfloat16> >(__nv_bfloat16 const*)"},
     "pack_taps (c)"),
    ({"cat": "kernel", "name": "void (anonymous namespace)::up_adjoint_pass(float const*, "
                               "int const*, int const*, float const*, __nv_bfloat16*)"},
     "up_adjoint_pass (c)"),
    ({"cat": "kernel", "name": "void gn::dx_gemm<__nv_bfloat16, gn::GLoad<__nv_bfloat16, true>, "
                               "gn::DxOut<__nv_bfloat16> >"},
     "dx_gemm<bf16, split> (m)"),
    ({"cat": "kernel", "name": "void gn::dx_gemm<__nv_bfloat16, gn::GLoad<__nv_bfloat16, false>, "
                               "gn::DxPairOut<__nv_bfloat16> >"},
     "dx_gemm<bf16, pair> (n)"),
    ({"cat": "kernel", "name": "void gn::dx_gemm<float, gn::GLoad<float, false>, "
                               "gn::DxPairOut<float> >"},
     "dx_gemm<fp32, pair> (n)"),
    # n's bf16 dx: c's cotangent pass, tap pack and GEMM tagged PairCells,
    # then its adjoint pass with the pair tail
    ({"cat": "kernel", "name": "void gn::cot_operand_pass<gn::PairCells<__nv_bfloat16>, false>"
                               "(gn::GLoad<__nv_bfloat16, false>, gn::CombRows)"},
     "cot_operand_pass<bf16> (n)"),
    ({"cat": "kernel", "name": "void gn::mma_conv<gn::PairCells<__nv_bfloat16>, gn::DuEpi>"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::DuEpi, int)"},
     "mma_conv_dx<bf16> (n)"),
    ({"cat": "kernel", "name": "void gn::pack_taps_t<__nv_bfloat16, gn::PairCells<"
                               "__nv_bfloat16> >(__nv_bfloat16 const*)"},
     "pack_taps (n)"),
    ({"cat": "kernel", "name": "void (anonymous namespace)::pair_adjoint_pass<gn::PairCells<"
                               "__nv_bfloat16> >(gn::UpAdjoint, (anonymous namespace)::PairTail)"},
     "pair_adjoint_pass (n)"),
    ({"cat": "kernel", "name": "void (anonymous namespace)::up_adjoint_pass<gn::GridCells<"
                               "__nv_bfloat16> >(gn::UpAdjoint, __nv_bfloat16*)"},
     "up_adjoint_pass (c)"),
    ({"cat": "kernel", "name": "void gn::dx_gemm<float, gn::GLoad<float, false>, "
                               "gn::DxOut<float> >"},
     "dx_gemm<fp32>"),
    # the merged blocks: o and p, bf16 on the tensor cores, float32 the SIMT tiles
    ({"cat": "kernel", "name": "void gn::mma_two_pass_block<gn::UpLoad<__nv_bfloat16, "
                               "gn::GridCells<__nv_bfloat16> > >(gn::MmaTwoPass<gn::UpLoad<"
                               "__nv_bfloat16, gn::GridCells<__nv_bfloat16> > >)"},
     "mma_two_pass_block<bf16, UpLoad> (o)"),
    ({"cat": "kernel", "name": "void gn::mma_two_pass_block<gn::GridLoad<__nv_bfloat16, false> >"
                               "(gn::MmaTwoPass<gn::GridLoad<__nv_bfloat16, false> >)"},
     "mma_two_pass_block<bf16, GridLoad> (p)"),
    ({"cat": "kernel", "name": "void gn::two_pass_block<float, gn::GridLoad<float, false> >"
                               "(gn::TwoPass<float, gn::GridLoad<float, false> >)"},
     "two_pass_block<fp32, GridLoad> (p)"),
    # j's bf16 backward: its cotangent and upsampled-operand passes, tap pack,
    # the one launch of both GEMMs and its upsample adjoint; the float32 and
    # the old bf16 SIMT merged tiles
    ({"cat": "kernel", "name": "void gn::mma_bwd<gn::MergedUp, false, gn::DuEpi>(gn::MmaBwd, "
                               "gn::DuEpi)"},
     "mma_bwd<bf16> (j)"),
    ({"cat": "kernel", "name": "void gn::cot_operand_pass<gn::MergedUp>"
                               "(gn::GLoad<__nv_bfloat16, false>, gn::CombRows)"},
     "cot_operand_pass<bf16> (j)"),
    ({"cat": "kernel", "name": "void gn::up_operand_pass<__nv_bfloat16, gn::MergedUp>"
                               "(gn::UpLoad<__nv_bfloat16, gn::GridCells<__nv_bfloat16> >)"},
     "up_operand_pass<bf16> (j)"),
    ({"cat": "kernel", "name": "void gn::pack_taps_t<__nv_bfloat16, gn::MergedUp>"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*)"},
     "pack_taps (j)"),
    ({"cat": "kernel", "name": "void (anonymous namespace)::up_adjoint_pass<gn::MergedUp>("
                               "float const*, int const*, int const*, float const*)"},
     "up_adjoint_pass (j)"),
    ({"cat": "kernel", "name": "void (anonymous namespace)::up_adjoint_pass<gn::GridCells<"
                               "__nv_bfloat16> >(float const*, int const*, int const*)"},
     "up_adjoint_pass (c)"),
    ({"cat": "kernel", "name": "void gn::merged_bwd<__nv_bfloat16, gn::UpLoad<__nv_bfloat16, "
                               "gn::GridCells<__nv_bfloat16> > >(gn::GLoad<__nv_bfloat16>)"},
     "merged_bwd<bf16, UpLoad>"),
    ({"cat": "kernel", "name": "void gn::merged_bwd<float, gn::UpLoad<float, gn::GridCells<"
                               "float> > >(gn::GLoad<float, false>)"},
     "merged_bwd<fp32, UpLoad>"),
    # m's bf16 dtaps: b's operand pass and GEMM, its own rows (G by SplitRows);
    # d's GEMM with its direct rows named; m's float32 SIMT split dtaps
    ({"cat": "kernel", "name": "void gn::grid_operand_pass<__nv_bfloat16, gn::SplitGrid>"
                               "(gn::GridLoad<__nv_bfloat16, false>, __nv_bfloat16*, int)"},
     "grid_operand_pass<bf16> (m)"),
    ({"cat": "kernel", "name": "void gn::mma_dtaps<gn::SplitGrid, true, true, gn::mma::SplitRows>"
                               "(gn::OperandRows, gn::GLoad<__nv_bfloat16, false>, "
                               "gn::mma::SplitRows, int)"},
     "mma_dtaps<bf16> (m)"),
    ({"cat": "kernel", "name": "void gn::mma_dtaps<gn::SplitGrid, false, false, "
                               "gn::mma::SplitRows>(gn::OperandRows)"},
     "mma_dtaps<bf16> (m)"),
    ({"cat": "kernel", "name": "void gn::mma_dtaps<gn::GridCells<__nv_bfloat16>, true, false, "
                               "gn::mma::DirectRows>(gn::OperandRows, gn::mma::DirectRows)"},
     "mma_dtaps<bf16> (d)"),
    ({"cat": "kernel", "name": "void gn::dtaps_gemm<float, gn::GridLoad<float, false>, "
                               "gn::GLoad<float, true> >"},
     "dtaps_gemm<fp32, GridLoad, split> (m)"),
    # i's bf16 backward: its cotangent and operand passes, tap pack and the
    # one launch of both GEMMs; m's bf16 dx: a's pass over the split
    # cotangent, tap pack and GEMM; i's float32 SIMT merged tiles
    ({"cat": "kernel", "name": "void gn::mma_bwd<gn::MergedPhase, true, gn::DxEpi<true> >"
                               "(gn::MmaBwd, gn::DxEpi<true>)"},
     "mma_bwd<bf16> (i)"),
    ({"cat": "kernel", "name": "void gn::cot_operand_pass<gn::MergedPhase, false>"
                               "(gn::GLoad<__nv_bfloat16, false>, gn::CombRows)"},
     "cot_operand_pass<bf16> (i)"),
    ({"cat": "kernel", "name": "void gn::grid_operand_pass<__nv_bfloat16, gn::MergedPhase>"
                               "(gn::GridLoad<__nv_bfloat16, false>, __nv_bfloat16*, int)"},
     "grid_operand_pass<bf16> (i)"),
    ({"cat": "kernel", "name": "void gn::pack_taps_t<__nv_bfloat16, gn::MergedPhase>"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*)"},
     "pack_taps (i)"),
    ({"cat": "kernel", "name": "void gn::cot_operand_pass<gn::SplitGrid, true>"
                               "(gn::GLoad<__nv_bfloat16, true>, gn::CombRows)"},
     "cot_operand_pass<bf16> (m)"),
    ({"cat": "kernel", "name": "void gn::mma_conv<gn::SplitGrid, gn::DxEpi<false> >"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::DxEpi<false>, int)"},
     "mma_conv_dx<bf16> (m)"),
    ({"cat": "kernel", "name": "void gn::pack_taps_t<__nv_bfloat16, gn::SplitGrid>"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*)"},
     "pack_taps (m)"),
    ({"cat": "kernel", "name": "void gn::merged_bwd<float, gn::GridLoad<float, false> >"
                               "(gn::GLoad<float, false>)"},
     "merged_bwd<fp32, GridLoad>"),
    # k's bf16 backward: f's cotangent and operand passes, tap pack and the
    # one launch of both GEMMs; m's bf16 forward: the split store's GEMM,
    # b's operand pass and tap pack (its pass shares m's dtaps' row)
    ({"cat": "kernel", "name": "void gn::mma_bwd<gn::MergedStd, false, gn::DxEpi<true> >"
                               "(gn::MmaBwd, gn::DxEpi<true>)"},
     "mma_bwd<bf16> (k)"),
    ({"cat": "kernel", "name": "void gn::mma_bwd<gn::MergedStd, true, gn::DxEpi<false> >"
                               "(gn::MmaBwd, gn::DxEpi<false>)"},
     "mma_bwd<bf16> (k)"),
    ({"cat": "kernel", "name": "void gn::cot_operand_pass<gn::MergedStd, false>"
                               "(gn::GLoad<__nv_bfloat16, false>, gn::CombRows)"},
     "cot_operand_pass<bf16> (k)"),
    ({"cat": "kernel", "name": "void gn::grid_operand_pass<__nv_bfloat16, gn::MergedStd>"
                               "(gn::GridLoad<__nv_bfloat16, false>, __nv_bfloat16*, int)"},
     "grid_operand_pass<bf16> (k)"),
    ({"cat": "kernel", "name": "void gn::pack_taps_t<__nv_bfloat16, gn::MergedStd>"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*)"},
     "pack_taps (k)"),
    ({"cat": "kernel", "name": "void gn::mma_conv<gn::SplitGrid, gn::SplitFwdEpi<true> >"
                               "(gn::OperandRows, __nv_bfloat16 const*, gn::SplitFwdEpi<true>, "
                               "int)"},
     "mma_conv_fwd<bf16> (m)"),
    ({"cat": "kernel", "name": "void gn::pack_taps<__nv_bfloat16, gn::SplitGrid>"
                               "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*)"},
     "pack_taps (m)"),
    ({"cat": "kernel", "name": "void gn::merged_bwd<__nv_bfloat16, gn::GridLoad<__nv_bfloat16, "
                               "false> >(gn::GLoad<__nv_bfloat16, false>)"},
     "merged_bwd<bf16, GridLoad>"),
    ({"cat": "kernel", "name": "void gn::conv_gemm<__nv_bfloat16, gn::GridLoad<__nv_bfloat16, "
                               "false>, true>(gn::GridLoad<__nv_bfloat16, false>)"},
     "conv_gemm<bf16, GridLoad, split> (m)"),
    ({"cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc"},
     "cuDNN / cuBLAS (plain route)"),
    ({"cat": "kernel", "name": "void at::native::elementwise_kernel<128, 2>"}, "PyTorch ops"),
    ({"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)"}, "gpu_memcpy"),
])
def test_profile_groups_device_events_by_kernel(event, group):
    assert chip_smoke.kernel_group(event) == group


def _groups(**calls):
    return {row: [n, 0.1 * n] for row, n in calls.items()}


@pytest.mark.parametrize("groups, launches, ok", [
    # every call of b and f ran its pass and its GEMM (a trace may lose some)
    ({"grid_operand_pass<bf16> (b)": 35, "mma_dtaps<bf16> (b)": 34,
      "grid_operand_pass<bf16> (f)": 15, "mma_dtaps<bf16> (f)": 15},
     {"phase_conv_dtaps": 7.0, "ico_conv_s2s_dtaps": 3.0}, True),
    ({}, {}, True),  # a serving window: neither ran
    # m's dtaps has its own rows (b's pass and GEMM over the split cotangent)
    ({"grid_operand_pass<bf16> (b)": 5, "mma_dtaps<bf16> (b)": 5,
      "grid_operand_pass<bf16> (m)": 15, "mma_dtaps<bf16> (m)": 15},
     {"phase_conv_dtaps": 1.0, "ds2s_dtaps": 3.0}, True),
    ({"grid_operand_pass<bf16> (b)": 35, "mma_dtaps<bf16> (b)": 35,
      "dtaps_gemm<bf16, GridLoad>": 15}, {"phase_conv_dtaps": 7.0}, False),
    ({"grid_operand_pass<bf16> (b)": 35}, {"phase_conv_dtaps": 7.0}, False),  # no GEMM
    ({"grid_operand_pass<bf16> (f)": 20, "mma_dtaps<bf16> (f)": 20},
     {"ico_conv_s2s_dtaps": 3.0}, False),  # more GEMMs than calls
    # the grid forwards: one pass a call of either wrapper, the forward's GEMM
    # a forward call
    ({"grid_operand_pass<bf16> (b)": 70, "mma_dtaps<bf16> (b)": 35,
      "mma_conv_fwd<bf16> (b)": 35, "grid_operand_pass<bf16> (f)": 30,
      "mma_dtaps<bf16> (f)": 15, "mma_conv_fwd<bf16> (f)": 15},
     {"phase_conv_fwd": 7.0, "phase_conv_dtaps": 7.0, "ico_conv_s2s_fwd": 3.0,
      "ico_conv_s2s_dtaps": 3.0}, True),
    ({"grid_operand_pass<bf16> (b)": 35, "mma_conv_fwd<bf16> (b)": 35,
      "grid_operand_pass<bf16> (f)": 15, "mma_conv_fwd<bf16> (f)": 15},
     {"phase_conv_fwd": 7.0, "ico_conv_s2s_fwd": 3.0}, True),  # a serving window
    ({"grid_operand_pass<bf16> (b)": 35, "mma_conv_fwd<bf16> (b)": 35,
      "two_pass_block<bf16, GridLoad> (p)": 15},
     {"phase_conv_fwd": 7.0}, True),  # p's SIMT tiles have their own row
    ({"grid_operand_pass<bf16> (b)": 35, "mma_conv_fwd<bf16> (b)": 35,
      "conv_gemm<bf16, GridLoad>": 15}, {"phase_conv_fwd": 7.0}, False),  # the SIMT forward
    ({"grid_operand_pass<bf16> (b)": 35}, {"phase_conv_fwd": 7.0}, False),  # no GEMM
    ({"mma_conv_fwd<bf16> (f)": 15}, {"ico_conv_s2s_fwd": 3.0}, False),  # no pass
    ({"grid_operand_pass<bf16> (b)": 70, "mma_conv_fwd<bf16> (b)": 35,
      "mma_dtaps<bf16> (b)": 35}, {"phase_conv_fwd": 7.0, "phase_conv_dtaps": 7.0,
                                   "ico_conv_s2s_fwd": 3.0}, False),  # f's forward missing
    # m's forward and dtaps share the SplitGrid operand pass: one a call of either
    ({"grid_operand_pass<bf16> (m)": 30, "mma_conv_fwd<bf16> (m)": 15,
      "mma_dtaps<bf16> (m)": 15}, {"ds2s_fwd": 3.0, "ds2s_dtaps": 3.0}, True),
    ({"grid_operand_pass<bf16> (m)": 15, "mma_conv_fwd<bf16> (m)": 15},
     {"ds2s_fwd": 3.0}, True),  # a serving window on the chain
    ({"grid_operand_pass<bf16> (m)": 15}, {"ds2s_fwd": 3.0}, False),  # m's forward, no GEMM
    ({"grid_operand_pass<bf16> (m)": 30, "mma_conv_fwd<bf16> (m)": 15,
      "mma_dtaps<bf16> (m)": 15}, {"ds2s_fwd": 3.0}, False),  # more passes than calls
    ({"grid_operand_pass<bf16> (m)": 15, "mma_conv_fwd<bf16> (m)": 15,
      "conv_gemm<bf16, GridLoad, split> (m)": 15}, {"ds2s_fwd": 3.0}, False),  # m's SIMT forward
])
def test_device_launches_of_the_grid_dtaps(groups, launches, ok):
    """``check_device_launches`` over 5 profiled iterations: each call of the
    grid convs' dtaps (b, f, m's) and forward (b, f, m's with the split
    store) shows its operand pass and its tensor-core GEMM, at most once a
    call, and no window the SIMT ``dtaps_gemm<bf16, GridLoad>`` or
    ``conv_gemm<bf16, GridLoad>``, m's split one included."""
    if ok:
        chip_smoke.check_device_launches("t", _groups(**groups), launches, 5)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_device_launches("t", _groups(**groups), launches, 5)


_DX = {"cot_operand_pass<bf16> (a)": 30, "mma_conv_dx<bf16> (a)": 30,
       "cot_operand_pass<bf16> (c)": 15, "mma_conv_dx<bf16> (c)": 15,
       "up_adjoint_pass (c)": 15, "cot_operand_pass<bf16> (f)": 15,
       "mma_conv_dx<bf16> (f)": 15}
_DX_CALLS = {"phase_conv_dx": 6.0, "up_dual_conv_dx": 3.0, "ico_conv_s2s_dx": 3.0}


@pytest.mark.parametrize("drop, add, ok", [
    ((), {}, True),                                # a default bf16 step
    (("mma_conv_dx<bf16> (a)",), {}, False),       # a without its GEMM
    (("cot_operand_pass<bf16> (c)",), {}, False),  # c without its pass
    (("up_adjoint_pass (c)",), {}, False),         # c without its adjoint
    ((), {"dx_gemm<bf16>": 15}, False),            # the SIMT dx in bf16
    (("mma_conv_dx<bf16> (f)",), {}, False),       # f's GEMM missing
    ((), {"dx_gemm<bf16, pair> (n)": 15}, False),  # n's SIMT dx in bf16
    ((), {"dx_gemm<bf16, split> (m)": 15}, False),  # m's SIMT dx in bf16
])
def test_device_launches_of_the_dx(drop, add, ok):
    """``check_device_launches`` over 5 profiled iterations of a bf16 step:
    every call of a, c and f shows its cotangent pass and ``mma_conv_dx``
    (c also its upsample adjoint), and neither the SIMT ``dx_gemm<bf16>``
    nor m's split one nor n's pair one runs."""
    groups = {k: v for k, v in {**_DX, **add}.items() if k not in drop}
    if ok:
        chip_smoke.check_device_launches("t", _groups(**groups), _DX_CALLS, 5)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_device_launches("t", _groups(**groups), _DX_CALLS, 5)


_SPLIT_ROUTE = {"cot_operand_pass<bf16> (j)": 15, "up_operand_pass<bf16> (j)": 15,
                "mma_bwd<bf16> (j)": 15, "up_adjoint_pass (j)": 15,
                "grid_operand_pass<bf16> (m)": 30, "mma_dtaps<bf16> (m)": 15,
                "mma_conv_fwd<bf16> (m)": 15,
                "cot_operand_pass<bf16> (i)": 30, "grid_operand_pass<bf16> (i)": 30,
                "mma_bwd<bf16> (i)": 30, "cot_operand_pass<bf16> (m)": 15,
                "mma_conv_dx<bf16> (m)": 15, "cot_operand_pass<bf16> (k)": 15,
                "grid_operand_pass<bf16> (k)": 15, "mma_bwd<bf16> (k)": 15,
                "cot_operand_pass<bf16> (n)": 10, "mma_conv_dx<bf16> (n)": 10,
                "pair_adjoint_pass (n)": 10}
_SPLIT_ROUTE_CALLS = {"up_dual_conv_bwd": 3.0, "ds2s_dtaps": 3.0, "phase_conv_bwd": 6.0,
                      "ds2s_dx": 3.0, "ico_conv_s2s_bwd": 3.0, "ds2s_fwd": 3.0,
                      "up_pair_dx": 2.0}


@pytest.mark.parametrize("drop, add, ok", [
    ((), {}, True),                                     # j and m's dtaps in a bf16 step
    (("mma_bwd<bf16> (j)",), {}, False),             # j without its GEMMs
    (("up_operand_pass<bf16> (j)",), {}, False),        # j without its upsampled operand
    (("cot_operand_pass<bf16> (j)",), {}, False),       # j without its cotangent pass
    (("up_adjoint_pass (j)",), {}, False),              # j without its adjoint
    (("mma_dtaps<bf16> (m)",), {}, False),              # m's dtaps without its GEMM
    (("grid_operand_pass<bf16> (m)",), {}, False),      # m's dtaps without its pass
    ((), {"mma_bwd<bf16> (j)": 30}, False),          # more GEMM launches than calls
    ((), {"merged_bwd<bf16, UpLoad>": 15}, False),      # j's SIMT tiles in bf16
    ((), {"dtaps_gemm<bf16, GridLoad, split> (m)": 15}, False),  # m's SIMT dtaps in bf16
    ((), {"pack_taps (k)": 15, "pack_taps (m)": 30}, True),  # k's and m's tap packs
    ((), {"dx_gemm<bf16, pair> (n)": 10}, False),      # n's SIMT dx in bf16
    (("mma_bwd<bf16> (i)",), {}, False),          # i without its GEMMs
    (("grid_operand_pass<bf16> (i)",), {}, False),      # i without its operand pass
    (("cot_operand_pass<bf16> (i)",), {}, False),       # i without its cotangent pass
    (("mma_conv_dx<bf16> (m)",), {}, False),            # m's dx without its GEMM
    (("cot_operand_pass<bf16> (m)",), {}, False),       # m's dx without its pass
    ((), {"merged_bwd<bf16, GridLoad>": 30}, False),    # i's SIMT tiles beside k's in bf16
    ((), {"dx_gemm<bf16, split> (m)": 15}, False),      # m's SIMT dx in bf16
    (("mma_bwd<bf16> (k)",), {}, False),                # k without its GEMMs
    (("cot_operand_pass<bf16> (k)",), {}, False),       # k without its cotangent pass
    (("grid_operand_pass<bf16> (k)",), {}, False),      # k without its operand pass
    ((), {"mma_bwd<bf16> (k)": 30}, False),             # more GEMM launches than calls
    ((), {"merged_bwd<bf16, GridLoad>": 15}, False),    # k's SIMT tiles in bf16
    (("mma_conv_fwd<bf16> (m)",), {}, False),           # m's forward without its GEMM
    ((), {"conv_gemm<bf16, GridLoad, split> (m)": 15}, False),  # m's SIMT forward in bf16
    (("cot_operand_pass<bf16> (n)",), {}, False),       # n's dx without its cotangent pass
    (("mma_conv_dx<bf16> (n)",), {}, False),            # n's dx without its GEMM
    (("pair_adjoint_pass (n)",), {}, False),            # n's dx without its adjoint pass
    ((), {"pair_adjoint_pass (n)": 20}, False),         # more adjoint passes than calls
    ((), {"pack_taps (n)": 10}, True),                  # n's tap pack
])
def test_device_launches_of_the_split_route_passes(drop, add, ok):
    """``check_device_launches`` over 5 profiled iterations of a bf16 step on
    the merged route and both chains: every call of i and k shows its two
    passes and its one launch of both GEMMs, every call of j the same and
    its upsample adjoint, every call of m's dx a's cotangent pass and GEMM,
    every call of n's dx c's cotangent pass and GEMM and its pair adjoint
    pass (``SPLIT_ROUTE_ROWS``), of m's forward and dtaps b's operand pass
    and their GEMM (``GRID_ROWS``); no window the SIMT merged tiles
    (``merged_bwd<bf16, UpLoad>``, ``merged_bwd<bf16, GridLoad>``), m's
    SIMT ``conv_gemm``, ``dx_gemm`` or ``dtaps_gemm`` with the split map
    or n's SIMT pair ``dx_gemm``."""
    groups = {k: v for k, v in {**_SPLIT_ROUTE, **add}.items() if k not in drop}
    if ok:
        chip_smoke.check_device_launches("t", _groups(**groups), _SPLIT_ROUTE_CALLS, 5)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_device_launches("t", _groups(**groups), _SPLIT_ROUTE_CALLS, 5)
