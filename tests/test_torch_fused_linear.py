"""The LinearRaw kernel's CPU side (``ops/fused_linear.py``): the
wrapper's CPU path (the plain lane it replaces,
``parallel/batch.batch_develop_linear_rgba``) in the kernel's output
forms; the per-image scalars against the lane's own; the lane's quantiser
table; the wrapper's and the launcher's checks; the kernel source's names
and constants; and the exporter's route to it (``linear.kernel_slots``).
The kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch.metrics._linear import PORT_KERNELS
from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import fused_develop as fd
from raweditor_tpu_torch.ops import fused_linear as fl
from raweditor_tpu_torch.ops.develop import _SLIDERS, _scalars, f32
from raweditor_tpu_torch.parallel.batch import batch_develop_linear_rgba
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw import synth

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "raweditor_tpu_torch" / "csrc" / "linear.cu").read_text()
EDITS = [EditParams(),
         EditParams(exposure=0.37, contrast=23.0, highlights=-0.4,
                    shadows=0.3, whites=1.05, blacks=0.04, vibrance=0.5,
                    saturation=-15.0, temperature=0.2, tint=-0.1),
         EditParams(exposure=-1.3, contrast=-50.0, saturation=60.0,
                    vibrance=-0.3),
         EditParams(exposure=2.1, highlights=0.8, shadows=-0.6, whites=0.9,
                    blacks=-0.05, temperature=-0.4, tint=0.3)]


def _flush(rng, n, h, w):
    """n seeded (h, w, 3) u16 frames with extreme samples (0, 65535, and
    100 below a black of 512.5) and the lane's per-image inputs."""
    f = rng.integers(0, 65536, (n, h, w, 3), dtype=np.uint16)
    flat = f.reshape(-1)
    flat[::7], flat[3::11], flat[5::13] = 0, 65535, 100
    i = np.arange(n) % 4
    inputs = ([EDITS[k % len(EDITS)] for k in range(n)],
              rng.uniform(0.5, 2.5, (n, 3)), rng.uniform(-0.5, 1.5, (n, 3, 3)),
              np.array([65535.0, 60000.0, 4095.0, 16383.0])[i],
              np.array([0.0, 512.5, 150.0, 64.0])[i])
    return torch.from_numpy(f), inputs


@pytest.mark.parametrize("transpose", [False, True], ids=["plain", "transposed"])
@pytest.mark.parametrize("gamma", sorted(fl.TRANSFER_BY_GAMMA))
@pytest.mark.parametrize("shape, output", [((3, 38, 54), "rgba"),
                                           ((3, 38, 54), "ycbcr420"),
                                           ((2, 37, 53), "rgba")], ids=str)
def test_the_wrapper_on_the_cpu_is_the_lane(rng, shape, output, gamma,
                                            transpose):
    """What CPU tensors run: the lane's RGBA words, or its Y and its Cb
    and Cr interleaved as the kernel's NV12 plane, bit for bit, with the
    gamma lane's transfer and the matrix as passed."""
    n, h, w = shape
    frames, inputs = _flush(rng, *shape)
    got = fl.fused_batch_develop_linear(frames, *inputs,
                                        matrix_transpose=transpose,
                                        gamma=gamma, output=output)
    lane = dict(matrix_transpose=transpose,
                transfer=fl.TRANSFER_BY_GAMMA[gamma])
    if output == "rgba":
        assert torch.equal(got, batch_develop_linear_rgba(frames, *inputs,
                                                          **lane))
        return
    y, cb, cr = batch_develop_linear_rgba(frames, *inputs, output="ycbcr420",
                                          **lane)
    assert got[1].shape == (n, h // 2, w)
    assert torch.equal(got[0], y)
    assert torch.equal(got[1][..., 0::2], cb)
    assert torch.equal(got[1][..., 1::2], cr)


def test_scalars_are_the_lanes(rng):
    """Every slot against the lane's operation on its 0-d tensors, image
    by image; 20 images, past the CPU's vector loop of exp2."""
    params = [EditParams(**{s: float(v) for s, v in zip(
        _SLIDERS, rng.uniform(-1.0, 1.0, len(_SLIDERS)) * (
            [5.0, 100.0, 1.0, 1.0, 1.0, 1.0, 1.0, 100.0, 1.0, 1.0]))})
        for _ in range(20)]
    n = len(params)
    wbs, cms = rng.uniform(0.5, 2.5, (n, 3)), rng.uniform(-1, 2, (n, 3, 3))
    whites, blacks = rng.uniform(4000, 65535, n), rng.uniform(0, 600, n)
    sc = fl.pack_linear_params(params, wbs, cms, whites, blacks,
                               matrix_transpose=True)
    assert sc.shape == (n, fl.N_LINEAR_SCALARS) and sc.dtype == torch.float32
    slot = {name: i for i, name in enumerate(fl.SCALAR_SLOTS)}
    for i, p in enumerate(params):
        s = _scalars(p, "cpu")
        lv = torch.tensor([float(np.float32(whites[i])),
                           float(np.float32(blacks[i]))], dtype=torch.float32)
        m = torch.as_tensor(cms[i].astype(np.float32)).T
        want = {"black": lv[1], "range": lv[0] - lv[1],
                "temp_r": 1.0 + s["temperature"] * f32(0.3),
                "tint": 1.0 + s["tint"] * f32(0.3),
                "temp_b": 1.0 - s["temperature"] * f32(0.3),
                "exposure": torch.exp2(s["exposure"]),
                "highlights": s["highlights"], "shadows": s["shadows"],
                "contrast": 1.0 + s["contrast"] / 100.0,
                "blacks": s["blacks"],
                "inv_range": 1.0 / (s["whites"] - s["blacks"]
                                    + f32(0.0001)),
                "saturation": 1.0 + s["saturation"] / 100.0,
                "vibrance": s["vibrance"]}
        want.update({f"wb_{c}": torch.tensor(np.float32(wbs[i, k]))
                     for k, c in enumerate("rgb")})
        want.update({f"m{a}{b}": m[a, b] for a in range(3) for b in range(3)})
        for name, v in want.items():
            assert torch.equal(sc[i, slot[name]], v.reshape(())), (i, name)


def _inputs(n):
    return ([EditParams()] * n, np.ones((n, 3)), np.tile(np.eye(3), (n, 1, 1)),
            np.full(n, 65535.0), np.zeros(n))


@pytest.mark.parametrize("bad, error", [
    (lambda f: f.to(torch.int32), TypeError),
    (lambda f: f[..., 0], ValueError),
    (lambda f: f[..., :2], ValueError),
    (lambda f: f[:, :0], ValueError),
    (lambda f: f[:1], ValueError),
    (lambda f: f.transpose(1, 2), ValueError),
], ids=["dtype", "no-channels", "two-channels", "empty", "images",
        "frames-strided"])
def test_the_wrapper_checks_its_inputs(bad, error):
    frames = bad(torch.zeros((2, 4, 6, 3), dtype=torch.uint16))
    with pytest.raises(error):
        fl.fused_batch_develop_linear(frames, *_inputs(2))


@pytest.mark.parametrize("bad, error", [
    (lambda s: s.double(), TypeError),
    (lambda s: s[:1], ValueError),
    (lambda s: s[:, :-1], ValueError),
    (lambda s: s.to("meta"), ValueError),
    (lambda s: torch.zeros((fl.N_LINEAR_SCALARS, 2)).T, ValueError),
    (lambda s: s, ValueError),
], ids=["scal-dtype", "scal-rows", "scal-columns", "devices", "scal-strided",
        "cpu"])
def test_the_launcher_checks_its_scalars(bad, error):
    """``launch_linear`` refuses a scalar table the kernel cannot read, and
    CPU tensors, which only the wrapper's plain path takes."""
    frames = torch.zeros((2, 4, 6, 3), dtype=torch.uint16)
    with pytest.raises(error):
        fl.launch_linear(frames, bad(fl.pack_linear_params(*_inputs(2))))


@pytest.mark.parametrize("gamma, output, shape", [
    ("cube", "rgba", (2, 4, 6, 3)), ("pow", "rgb", (2, 4, 6, 3)),
    ("pow", "ycbcr420", (2, 5, 6, 3)), ("pow", "ycbcr420", (2, 4, 7, 3))])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(gamma, output,
                                                           shape):
    with pytest.raises(ValueError):
        fl.fused_batch_develop_linear(
            torch.zeros(shape, dtype=torch.uint16), *_inputs(2),
            gamma=gamma, output=output)


@pytest.mark.parametrize("gamma", sorted(fl.TRANSFER_BY_GAMMA))
def test_lane_table_equals_the_lanes_finish(gamma, rng):
    """The LinearRaw table (derived from ``finish_to_u8``'s transfer,
    clamp and quantiser) against that function on a seeded 10**6 values
    in [0, 1], every threshold and 4 ulp around it, and special values;
    for the exact transfers it is the develop kernels' table."""
    table, data = fl.lane_quant_table(gamma, torch.device("cpu"))
    assert data.dtype == torch.uint8 and data.numel() == 5456
    t = torch.from_numpy(table.next[:255, 0].astype(np.int64))
    finite = t[t < 2**31 - 1]
    assert finite.numel() == 255
    near = (finite[:, None] + torch.arange(-4, 5)).reshape(-1).to(
        torch.int32).view(torch.float32)
    c = torch.cat([torch.from_numpy(rng.uniform(0, 1, 10**6).astype(
        np.float32)), near, torch.tensor(
        [-0.0, 0.0, -1.0, -1e-42, 1e-45, 1e-40, 1.0, 1.0000001, 2.0,
         float("inf"), -float("inf")])])
    assert torch.equal(table.lookup(c), fl._lane_quantize(c, gamma).to(
        torch.int64))
    assert torch.equal(fl.linear_quantize(c, gamma),
                       fl._lane_quantize(c, gamma).to(torch.uint8))
    if gamma in ("pow", "srgb"):
        assert table.packed == fd.quant_table(gamma, torch.device("cpu"))[
            0].packed


def _kernels(src):
    """Each ``__global__`` kernel's declaration: from ``__global__`` to the
    body's brace, template and parameter types included."""
    return re.findall(r"(template\s*<[^>]*>\s*__global__[^{]*|__global__[^{]*)",
                      src)


def test_the_kernel_name_lies_outside_the_benchmarks_port_kernels():
    """The LinearRaw lane's readers take every kernel whose name holds none
    of ``PORT_KERNELS`` as the lane's: the kernel's name, template and
    parameter types must hold none, so its time is read as the lane's."""
    kernels = _kernels(SOURCE)
    assert len(kernels) == 1 and "linear_quads(" in kernels[0]
    signature = kernels[0] + " QuantTable LinearTail"
    for name in PORT_KERNELS:
        assert name not in signature
        assert name not in "(anonymous namespace)::linear_quads<true>"


def test_the_launcher_signature_matches_the_source():
    decl = re.search(r'extern "C" int rtt_linear_launch\(([^)]*)\)',
                     SOURCE).group(1)
    params = [p.strip() for p in decl.split(",")]
    kinds = ["ptr" if "*" in p else "int" for p in params]
    assert kinds == ["ptr"] * 4 + ["int"] * 4 + ["ptr"] * 2
    import ctypes

    want = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    assert _build.SIGNATURES["rtt_linear_launch"] == want


def test_the_kernel_constants_match_the_checks():
    """chip_smoke.py and the card tests pick their edge frames around the
    kernel's thread, tile and block; they read the sizes as literals."""
    import chip_smoke

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             SOURCE).group(1).split("//")[0].split()[0])

    cols, bx, by, rows = (const(k) for k in ("kLinCols", "kLinBlockX",
                                             "kLinBlockY", "kLinTileRows"))
    assert (chip_smoke.LINEAR_COLS, chip_smoke.LINEAR_TILE_W,
            chip_smoke.LINEAR_BLOCK_H) == (cols, cols * bx, 2 * by * rows)
    assert len(fl.SCALAR_SLOTS) == fl.N_LINEAR_SCALARS == const(
        "kLinearScalars")
    slots = dict(re.findall(r"\b(k[A-Z]\w*) = (\d+),", SOURCE.split(
        "enum Slot")[1].split("};")[0]))
    assert int(slots["kVibrance"]) == fl.SCALAR_SLOTS.index("vibrance")
    assert int(slots["kMatrix"]) == fl.SCALAR_SLOTS.index("m00")
    assert int(slots["kExposure"]) == fl.SCALAR_SLOTS.index("exposure")


# -- the exporter's route ---------------------------------------------------------

def _linear_files(root, n, rng, shape=(16, 24)):
    root.mkdir(exist_ok=True)
    paths = []
    for i in range(n):
        p = root / f"l{i}.dng"
        synth.write_synthetic_linear_dng(
            p, rng.integers(0, 65536, size=shape + (3,), dtype=np.uint16),
            wb_neutral=(0.5, 1.0, 0.625), uncorrelated_preview=True)
        paths.append(str(p))
    return paths


def _export(paths, out, ext, params=EditParams(exposure=0.2), **kw):
    jobs = [pex.ExportJob(p, str(out / f"{i}.{ext}"), params)
            for i, p in enumerate(paths)]
    rep = pex.run_batch_export(jobs, batch_size=2, device="cpu", **kw)
    assert rep.succeeded == len(jobs) and not rep.failed
    return rep, [open(j.out_path, "rb").read() for j in jobs]


def test_a_linear_flush_takes_the_kernel(tmp_path, rng, monkeypatch):
    """use_kernel, a transfer the kernels compute, no point curve: every
    LinearRaw slot on the kernel (planes for the JPEGs), counted as the
    lane's route and as ``linear.kernel_slots``; the files equal the
    plain lane's."""
    calls = []
    real = fl.fused_batch_develop_linear

    def seen(frames, *inputs, **kw):
        calls.append((tuple(frames.shape), kw["gamma"], kw["output"]))
        return real(frames, *inputs, **kw)

    monkeypatch.setattr(fl, "fused_batch_develop_linear", seen)
    paths = _linear_files(tmp_path / "raw", 5, rng)
    rep, files = _export(paths, tmp_path, "jpg", use_kernel=True,
                         mode="accurate")
    counters = rep.stages["counters"]
    assert counters["linear.kernel_slots"] == counters[
        "develop.slots.linear"] == counters["slots.developed"] == 5
    assert calls == [((2, 16, 24, 3), "pow", "ycbcr420")] * 2 + [
        ((1, 16, 24, 3), "pow", "ycbcr420")]
    out = tmp_path / "plain"
    out.mkdir()
    _, plain = _export(paths, out, "jpg", mode="accurate")
    assert files == plain


def test_a_linear_flush_with_extras_takes_the_kernel_to_words(tmp_path, rng,
                                                              monkeypatch):
    calls = []
    real = fl.fused_batch_develop_linear
    monkeypatch.setattr(fl, "fused_batch_develop_linear",
                        lambda f, *inputs, **kw: (
                            calls.append(kw["output"]) or real(f, *inputs,
                                                               **kw)))
    paths = _linear_files(tmp_path / "raw", 2, rng)
    rep, _ = _export(paths, tmp_path, "jpg", EditParams(sharpen=40.0),
                     use_kernel=True, mode="parity")
    counters = rep.stages["counters"]
    assert counters["linear.kernel_slots"] == counters["extras.slots"] == 2
    assert calls == ["rgba"]


@pytest.mark.parametrize("case", ["point curve", "adobe-rgb", "bits=16",
                                  "no use_kernel"])
def test_a_linear_flush_that_the_kernel_does_not_take(tmp_path, rng, case):
    """The plain lane, unchanged: a point curve, the Adobe RGB transfer,
    16-bit output or no ``use_kernel``; no slot counts as the kernel's."""
    kw = dict(mode="accurate", use_kernel=True)
    params, ext = EditParams(exposure=0.2), "jpg"
    if case == "point curve":
        params = params.replace(point_curve=((0.0, 0.05), (0.5, 0.6),
                                             (1.0, 1.0)))
    elif case == "adobe-rgb":
        kw["color_space"] = "adobe-rgb"
    elif case == "bits=16":
        kw["bits"], ext = 16, "tif"
    else:
        kw["use_kernel"] = False
    paths = _linear_files(tmp_path / "raw", 3, rng)
    rep, _ = _export(paths, tmp_path, ext, params, **kw)
    counters = rep.stages["counters"]
    assert counters["develop.slots.linear"] == 3
    assert counters.get("linear.kernel_slots", 0) == 0
