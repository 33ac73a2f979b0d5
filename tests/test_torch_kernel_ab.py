"""The kernel A/B tool's host side (``tools/kernel_ab.py``), which needs no
card, and the strip and band sizes that ``chip_smoke.py`` and the card
tests take their edge frames from, held against the kernel sources."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.tools import kernel_ab

ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- kernel_ab ------------------------------------------------------------------

def test_parse_args_variant_specs_with_defines():
    args, variants = kernel_ab.parse_args([
        "--variant", "parent=build/parent/raweditor_tpu_torch/csrc",
        "--variant", "cut=build/copy,-DCUT_TAIL,-DBAND_H=32",
        "--sass", "cut", "--rounds", "2", "--cases", "B8,B6_rgba"])
    assert variants == [
        {"name": "parent", "dir": "build/parent/raweditor_tpu_torch/csrc",
         "defs": []},
        {"name": "cut", "dir": "build/copy",
         "defs": ["-DCUT_TAIL", "-DBAND_H=32"]}]
    assert args.sass == ["cut"] and args.rounds == 2 and args.reps == 5
    assert args.cases == ["B6_rgba", "B8_rgba", "B8_rgba_stencils",
                          "B8_rgba_mixer", "B8_rgba_pointwise", "B8_planes"]


def test_parse_args_defaults_to_every_case():
    args, _ = kernel_ab.parse_args(["--variant", "new=raweditor_tpu_torch/csrc"])
    assert args.cases == list(kernel_ab.CASES) + list(kernel_ab.STAGING_CASES)
    with pytest.raises(SystemExit):
        kernel_ab.parse_args(["--variant", "a=b", "--cases", "B9"])


@pytest.mark.parametrize("opcode, cls", [
    ("LDS", "LDS"), ("STS", "STS"), ("LDG", "GMEM/const"), ("BAR", "BAR"),
    ("MUFU", "MUFU"), ("FFMA", "f32"), ("IMAD", "int/move"),
    ("SHFL", "SHFL"), ("BRA", "control"), ("NOP", "NOP"),
    ("HMMA", "other:HMMA")])
def test_classify_one_opcode_of_each_class(opcode, cls):
    assert kernel_ab.classify(opcode) == cls


PTXAS = """\
ptxas info    : 0 bytes gmem, 116 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN4demo12extras_bandsILb1ELb1ELb0EEEvPKjPKfiiffffPjPhS6_' for 'sm_90a'
ptxas info    : Function properties for _ZN4demo12extras_bandsILb1ELb1ELb0EEEvPKjPKfiiffffPjPhS6_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 312 bytes smem
ptxas info    : Compiling entry function '_ZN4demo12extras_quadsILb1ELb0ELb0EEEvPKjPKfiiPjPhS6_' for 'sm_90a'
ptxas info    : Function properties for _ZN4demo12extras_quadsILb1ELb0ELb0EEEvPKjPKfiiPjPhS6_
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 312 bytes smem
"""


def test_ptxas_summary_on_a_captured_report():
    picked = kernel_ab.ptxas_summary(PTXAS, kernel_ab.INSTANCES["extras.cu"])
    assert picked.count("\n") == 0  # one entry function
    assert "extras_bandsILb1ELb1ELb0E" in picked
    assert "Used 96 registers" in picked and "0 bytes spill stores" in picked
    assert "extras_quads" not in picked
    both = kernel_ab.ptxas_summary(PTXAS, ("extras_",))
    assert both.count("\n") == 1 and "Used 40 registers" in both
    assert kernel_ab.ptxas_summary(PTXAS) == ""  # no sRGB develop kernel


@pytest.mark.parametrize("case", sorted(kernel_ab.CASES))
def test_every_case_names_a_declared_launcher_and_its_source(case):
    spec = kernel_ab.CASES[case]
    launcher = spec["launcher"]
    assert launcher in _build.SIGNATURES
    source = kernel_ab.SOURCES[launcher]
    text = (_build.CSRC / source).read_text()
    assert f'extern "C" int {launcher}(' in text
    assert source in kernel_ab.INSTANCES
    assert spec["frames"] in (1, 4) and spec["output"] in (0, 1)
    assert spec["output"] == (1 if case.endswith("_planes") else 0)
    assert kernel_ab.sources_for([case]) == [source]


def test_sources_for_builds_only_what_the_cases_launch():
    assert kernel_ab.sources_for(kernel_ab.pick_cases(["B8"])) == ["extras.cu"]
    assert kernel_ab.sources_for(kernel_ab.pick_cases(["B5", "B6"])) == [
        "develop.cu"]
    assert kernel_ab.sources_for(kernel_ab.pick_cases(["S"])) == [
        "staging.cu"]
    assert kernel_ab.sources_for(kernel_ab.pick_cases([])) == sorted(
        set(kernel_ab.SOURCES.values()))


@pytest.mark.parametrize("case", sorted(kernel_ab.STAGING_CASES))
def test_every_staging_case_launches_the_staging_kernel(case):
    """A staging case names the staging launcher, builds ``staging.cu``
    alone, passes the launcher's arguments (the slots' sources, repeats
    of the first among them, their slots, u12 or u14) and states the
    bound of its bytes: each distinct source read once, every slot
    written."""
    spec = kernel_ab.STAGING_CASES[case]
    assert spec["launcher"] == "rtt_unpack_slots_launch"
    assert kernel_ab.sources_for([case]) == ["staging.cu"]
    assert f'extern "C" int {spec["launcher"]}(' in (
        _build.CSRC / "staging.cu").read_text()
    h, w = spec["frame"]
    small = dict(spec, frame=(4, 8))
    bufs = [torch.zeros((4, 12 if spec["fmt"] == "u12" else 14),
                        dtype=torch.uint8) + i
            for i in range(spec["sources"])]
    out = torch.empty((spec["slots"], 4, 8), dtype=torch.uint16)
    lib = _Recorder()
    go, outs = kernel_ab.staging_runner(lib, small, bufs, out, 0)
    go()
    (name, args), = lib.calls
    assert name == spec["launcher"]
    assert len(args) == len(_build.SIGNATURES[name])
    srcs, dsts, fmts, n, samples, _ = args
    assert n == spec["slots"] and samples == 32 and outs == (out,)
    want = [bufs[i if i < len(bufs) else 0].data_ptr() for i in range(n)]
    assert list(srcs) == want
    assert list(dsts) == [out[i].data_ptr() for i in range(n)]
    assert list(fmts) == [0 if spec["fmt"] == "u12" else 1] * n
    packed = h * w * (3 if spec["fmt"] == "u12" else 7) // (
        2 if spec["fmt"] == "u12" else 4)
    assert kernel_ab.staging_bound_ms(spec) == pytest.approx(
        1e3 * (spec["sources"] * packed + n * h * w * 2) / 3.35e12)


def test_build_signatures_cover_the_c_interface():
    """Every launcher a source exports is declared, and nothing else."""
    exported = set()
    for src in _build._sources():
        exported |= set(re.findall(r'extern "C" int (rtt_\w+)\(',
                                   src.read_text()))
    assert exported == set(_build.SIGNATURES)


# -- strips and bands -----------------------------------------------------------

def _constants(*names):
    """The ``constexpr int`` constants of the named csrc files."""
    env = {}
    for name in names:
        text = re.sub(r"//[^\n]*", "", (_build.CSRC / name).read_text())
        for const, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);",
                                      text):
            env[const] = int(eval(expr, {"__builtins__": {}}, dict(env)))
    return env


def _edges(unit):
    return {unit - 1, unit, unit + 1, 2 * unit - 1, 2 * unit, 2 * unit + 1}


KERNEL_EDGES = {
    # name: sources, strip constant, band constant, halo constant
    "grad": (("band_march.cuh", "grad_tile.cuh"), "kStripW", "kBandH",
             "kHalo"),
    "extras": (("band_march.cuh", "extras.cu"), "kStripW", "kBandH", "kHalo"),
    "cfa": (("band_march.cuh", "develop.cu"), "kCfaStripW", "kCfaBandH",
            "kCfaHalo"),
}


@pytest.mark.parametrize("kernel", sorted(KERNEL_EDGES))
def test_edge_frames_follow_the_kernels_strip_and_band(kernel):
    """``chip_smoke.py`` and the card tests compare each band kernel with
    its plain version on frames one below, at and one above its strip
    width and band height and their doubles; the sizes must follow the
    constants in the sources."""
    sources, strip_name, band_name, halo_name = KERNEL_EDGES[kernel]
    env = _constants(*sources)
    strip, band = env[strip_name], env[band_name]
    assert strip == env["kWarpCols"] - 2 * env[halo_name]
    assert band % 2 == 0  # whole quads per band
    smoke = _load("chip_smoke_for_edges", ROOT / "chip_smoke.py")
    cards = _load("cuda_tests_for_edges", ROOT / "tests" / "test_torch_cuda.py")
    if kernel == "grad":
        smoke_w, smoke_h = smoke.GRAD_EDGE_W, smoke.GRAD_EDGE_H
        smoke_even = smoke.GRAD_EDGE_EVEN
        card_rgba, card_planes = cards.GRAD_EDGE_RGBA, cards.GRAD_EDGE_PLANES
    else:
        up = kernel.upper()
        assert getattr(smoke, f"{up}_STRIP") == strip
        assert getattr(smoke, f"{up}_BAND") == band
        smoke_w = getattr(smoke, f"{up}_EDGE_W")
        smoke_h = getattr(smoke, f"{up}_EDGE_H")
        smoke_even = getattr(smoke, f"{up}_EDGE_EVEN")
        card_rgba = getattr(cards, f"{up}_EDGE_RGBA")
        card_planes = getattr(cards, f"{up}_EDGE_PLANES")
    assert _edges(strip) <= set(smoke_w) and _edges(band) <= set(smoke_h)
    assert 1 in smoke_w and 1 in smoke_h
    assert _edges(strip) <= {w for _, w in card_rgba}
    assert _edges(band) <= {h for h, _ in card_rgba}
    for planes in (smoke_even, card_planes):
        assert all(h % 2 == 0 and w % 2 == 0 for h, w in planes)
        assert {band - 2, band, band + 2, 2 * band} <= {h for h, _ in planes}
        assert {strip - 2, strip, strip + 2, 2 * strip} <= {
            w for _, w in planes}


def test_edge_frames_follow_the_bayer_quad_tile():
    """``chip_smoke.py`` and the card tests compare the Bayer quad kernel
    with its plain version on frames around its tile, whose width and
    height must follow the constants in ``develop.cu``, and at every width
    modulo a thread's columns."""
    env = _constants("band_march.cuh", "develop.cu")
    tile_w, tile_h = env["kBayerTileW"], env["kBayerTileH"]
    block_h, cols = env["kBayerBlockH"], env["kThreadCols"]
    assert tile_w == env["kBlockX"] * cols and tile_h == env["kBlockY"] * 2
    assert block_h == tile_h * env["kTileRows"]
    smoke = _load("chip_smoke_for_quads", ROOT / "chip_smoke.py")
    cards = _load("cuda_tests_for_quads", ROOT / "tests" / "test_torch_cuda.py")
    assert (smoke.BAYER_TILE_W, smoke.BAYER_TILE_H, smoke.BAYER_BLOCK_H,
            smoke.BAYER_THREAD_COLS) == (tile_w, tile_h, block_h, cols)
    for widths, heights in (
            (smoke.BAYER_EDGE_W, smoke.BAYER_EDGE_H),
            ({w for _, w in cards.BAYER_EDGE_RGBA},
             {h for h, _ in cards.BAYER_EDGE_RGBA})):
        assert _edges(tile_w) <= set(widths)
        assert _edges(tile_h) | _edges(block_h) <= set(heights)
        assert {w % cols for w in widths} == set(range(cols))
        assert 1 in widths and 1 in heights
    for planes in (smoke.BAYER_EDGE_EVEN, cards.BAYER_EDGE_PLANES):
        assert all(h % 2 == 0 and w % 2 == 0 for h, w in planes)
        for unit in (tile_h, block_h):
            assert {unit - 2, unit, unit + 2, 2 * unit} <= {
                h for h, _ in planes}
        assert {tile_w - 2, tile_w, tile_w + 2, 2 * tile_w} <= {
            w for _, w in planes}


# -- the launchers' two interfaces ----------------------------------------------

class _Recorder:
    """A stand-in library whose launchers record their arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


def _cpu_inputs(h=8, w=12):
    rng = np.random.default_rng(5)
    mos = torch.from_numpy(rng.integers(0, 4096, (4, h, w), dtype=np.uint16))
    scal = torch.zeros(4, fd.N_SCALARS)
    words = torch.zeros(4, h, w, dtype=torch.int32).view(torch.uint32)
    inputs = {name: (mos, scal) for name in kernel_ab.SOURCES}
    inputs["rtt_extras_launch"] = (words, torch.zeros(4, 64))
    inputs["tables"] = fd.cfa_tables(fd.cfa_generic.XTRANS_PATTERN).packed
    return inputs


@pytest.mark.parametrize("table", [True, False], ids=["table", "code"])
@pytest.mark.parametrize("case", sorted(kernel_ab.CASES))
def test_every_case_passes_its_launchers_arguments(case, table):
    """The arguments a case passes match the launcher's C signature: the
    current one (``_build.SIGNATURES``, the quantiser table) or, for a
    variant from before the table, the transfer's code instead."""
    lib = _Recorder()
    go, outs = kernel_ab.runner(lib, kernel_ab.CASES[case], _cpu_inputs(),
                                0, table)
    go()
    (name, args), = lib.calls
    spec = kernel_ab.CASES[case]
    assert name == spec["launcher"]
    sig = (_build.SIGNATURES[name] if table or name == "rtt_extras_launch"
           else kernel_ab.CODE_SIGNATURES[name])
    assert len(args) == len(sig)
    assert args[4] == spec["frames"]
    assert outs[0].shape[0] == spec["frames"]
    if name != "rtt_extras_launch":
        code = spec.get("gamma", 2)
        if table:  # the table of the case's transfer, on the data's device
            want = fd.quant_table(kernel_ab.GAMMA_NAMES[code],
                                  outs[0].device)[1].data_ptr()
            assert args[-2] == want
        else:  # the code after (n, h, w) and, on a Bayer phase, (py, px)
            assert args[9 if "cfa" not in name else 7] == code


def test_takes_table_reads_the_launcher(tmp_path):
    assert kernel_ab.takes_table(_build.CSRC)
    (tmp_path / "develop.cu").write_text(
        'extern "C" int rtt_develop_launch(const void* mosaics, int gamma,\n'
        '    int output, void* stream) {\n  const void* quant;\n}\n')
    assert not kernel_ab.takes_table(tmp_path)


def test_code_signatures_differ_from_the_table_ones_by_one_swap():
    """Before the table each develop launcher took an int transfer code
    where it now takes the table pointer: the same arity."""
    for name, old in kernel_ab.CODE_SIGNATURES.items():
        assert len(old) == len(_build.SIGNATURES[name])
