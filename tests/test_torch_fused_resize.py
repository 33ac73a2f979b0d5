"""The banded resize's CPU side (``ops/fused_resize.py``): the band tables
against the program's dense weights, the plain banded version against
``resize_hw`` and ``jax.image.resize``, its sums' order, its batches and
planes, the kernel's plan (its march mirrored in Python, bit for bit the
plain version), the wrapper's and the launcher's checks, the kernel
source's names, and the exporter's one resize a shaped flush
(``resize.kernel_images``). The kernel itself runs on the card only
(tests/test_torch_cuda.py, chip_smoke.py)."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_torch.metrics._linear import PORT_KERNELS
from raweditor_tpu.ops import resize as jrs
from raweditor_tpu_torch import EditParams
from raweditor_tpu_torch.ops import _build
from raweditor_tpu_torch.ops import fused_resize as fr
from raweditor_tpu_torch.ops import resize as rs
from raweditor_tpu_torch.ops.develop import pack_rgba, unpack_rgba
from raweditor_tpu_torch.ops.jpeg import rgba_words_to_ycbcr420
from raweditor_tpu_torch.pipeline import export as pex
from raweditor_tpu_torch.raw import synth

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "raweditor_tpu_torch" / "csrc" / "resize.cu").read_text()
F32 = torch.float32


def _words(rng, *shape):
    """Seeded packed RGBA words, every bit random (alpha too)."""
    bits = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(bits.view(np.int32)).view(torch.uint32)


def _max_lsb(a, b):
    return max(int((x - y).abs().max())
               for x, y in zip(unpack_rgba(a), unpack_rgba(b)))


def _dense(words, out_w, out_h, method):
    """The dense per-axis products (``resize_hw``) over the words' bytes."""
    planes = torch.stack([c.to(F32) for c in unpack_rgba(words)], dim=-3)
    q = torch.clamp(torch.round(rs.resize_hw(planes, out_h, out_w, method)),
                    0, 255)
    return pack_rgba(q[..., 0, :, :], q[..., 1, :, :], q[..., 2, :, :])


# -- the band tables ------------------------------------------------------------

@pytest.mark.parametrize("method", rs.METHODS)
@pytest.mark.parametrize("n_in, n_out", [(96, 24), (611, 150), (397, 120),
                                         (100, 67), (41, 41), (300, 611),
                                         (5464, 1366)])
def test_the_band_table_holds_every_nonzero_weight(n_in, n_out, method):
    """Scattered back, the band is the dense matrix exactly: every weight
    outside it is 0.0, and its padding is 0.0. T is the widest span, as
    wide as the kernel's support at the ratio (6 taps a unit of it for
    Lanczos-3, 2 for the tent); at 4:1 Lanczos-3 takes 24 to 26."""
    dense = rs.weight_matrix(n_in, n_out, method)
    first, weights = fr.band_table(n_in, n_out, method)
    taps = weights.shape[1]
    assert weights.dtype == F32 and tuple(weights.shape) == (n_out, taps)
    back = torch.zeros((n_out, n_in + taps), dtype=F32)
    back.scatter_(1, first[:, None] + torch.arange(taps), weights)
    assert torch.equal(back[:, n_in:], torch.zeros_like(back[:, n_in:]))
    assert torch.equal(back[:, :n_in], dense.T)
    nz = dense.T != 0
    assert torch.equal(first, nz.int().argmax(1))
    span = n_in - nz.flip(1).int().argmax(1) - first
    assert taps == int(span.max())
    support = (3.0 if method == "lanczos3" else 1.0) * 2 * max(
        1.0, n_in / n_out)
    if n_in != n_out:  # a kept axis takes no pass
        assert math.floor(support) <= taps <= math.ceil(support) + 1
    if n_in == 4 * n_out and method == "lanczos3":
        assert 24 <= taps <= 26


# -- the plain banded version ------------------------------------------------------

SIZES = [(64, 96, 16, 24), (61, 97, 15, 24), (66, 99, 20, 30),
         (40, 61, 26, 40), (40, 61, 40, 19), (33, 47, 11, 47),
         (30, 45, 61, 90), (29, 31, 29, 31)]


@pytest.mark.parametrize("method", rs.METHODS)
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_the_plain_version_is_within_1_lsb_of_the_dense_and_of_jax(
        rng, size, method):
    """4:1, odd sizes, 3.3:1, 1.5:1, one axis kept each way, an upscale
    and no change: within 1 LSB of ``resize_hw``'s dense products and of
    the JAX package's ``jax.image.resize``; alpha opaque."""
    h, w, oh, ow = size
    words = _words(rng, 2, h, w)
    got = fr.resize_words_banded_plain(words, ow, oh, method)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (2, oh, ow)
    assert bool(((got.view(torch.int32).to(torch.int64) >> 24 & 0xFF)
                 == 0xFF).all())
    assert _max_lsb(got, _dense(words, ow, oh, method)) <= 1
    want = np.asarray(jrs.resize_rgba_words(
        jnp.asarray(words.view(torch.int32).numpy().view(np.uint32)), ow, oh,
        method=method))
    ref = torch.from_numpy(want.view(np.int32).copy()).view(torch.uint32)
    assert _max_lsb(got, ref) <= 1
    assert torch.equal(rs.resize_rgba_words(words, ow, oh, method).view(
        torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("size", [(64, 96, 16, 24), (40, 61, 26, 40),
                                  (30, 45, 61, 90)], ids=str)
def test_each_output_sums_its_band_tap_by_tap_in_ascending_order(rng, size):
    """Every f32 of the first pass, and of the second over the first's,
    is ``acc = acc + x * w`` from 0 in ascending input index, each
    operation rounded alone (numpy float32 scalars), in the order
    ``resize_hw`` runs the passes."""
    h, w, oh, ow = size
    x = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.float32))
    rows = rs.rows_first(h, w, oh, ow)
    got = fr.resize_f32_banded(x, oh, ow).numpy()

    def along(a, n_out, axis):
        first, wts = (t.numpy() for t in fr.band_table(a.shape[axis], n_out))
        a = np.moveaxis(a, axis, 0)
        out = np.zeros((n_out,) + a.shape[1:], np.float32)
        for o in range(n_out):
            for j in range(a.shape[1]):
                acc = np.float32(0.0)
                for t in range(wts.shape[1]):
                    i = min(first[o] + t, a.shape[0] - 1)
                    acc = np.float32(acc + np.float32(a[i, j] * wts[o, t]))
                out[o, j] = acc
        return np.moveaxis(out, 0, axis)

    a = x.numpy()
    want = (along(along(a, oh, 0), ow, 1) if rows
            else along(along(a, ow, 1), oh, 0))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_a_batch_equals_its_images_one_by_one(rng, n):
    words = _words(rng, n, 61, 97)
    got = fr.resize_words(words, 24, 15)
    assert tuple(got.shape) == (n, 15, 24)
    for i in range(n):
        one = fr.resize_words(words[i], 24, 15)
        assert torch.equal(got[i].view(torch.int32), one.view(torch.int32))
    planes = fr.resize_words(words, 24, 16, output="ycbcr420")
    for i in range(n):
        for a, b in zip(planes, fr.resize_words(words[i].contiguous(), 24, 16,
                                                output="ycbcr420")):
            assert torch.equal(a[i], b)


@pytest.mark.parametrize("size", [(64, 96, 16, 24), (61, 97, 30, 48)],
                         ids=str)
def test_the_planes_are_the_conversion_of_the_words(rng, size):
    h, w, oh, ow = size
    words = _words(rng, 3, h, w)
    y, cb, cr = fr.resize_words(words, ow, oh, output="ycbcr420")
    want = rgba_words_to_ycbcr420(fr.resize_words(words, ow, oh))
    assert (y.shape, cb.shape, cr.shape) == ((3, oh, ow),
                                             (3, oh // 2, ow // 2),
                                             (3, oh // 2, ow // 2))
    for a, b in zip((y, cb, cr), want):
        assert a.dtype == torch.uint8 and torch.equal(a, b)


# -- the kernel's plan, its march mirrored ---------------------------------------

def _march(words, out_h, out_w):
    """csrc/resize.cu's loops over ``kernel_plan``'s tables in Python, f32
    elementwise: per block (strip, band, image), the ring of live outputs
    marching down the input rows, each finished row handed to the column
    pass. Returns (N, out_h, out_w) words."""
    n, h, w = words.shape
    plan = fr.kernel_plan(h, w, out_h, out_w)
    it, ft = plan.itab.tolist(), plan.ftab
    ring, tr = plan.ring, plan.transposed
    window = fr.THREADS * fr.COLUMNS[ring]
    om, oc = (out_w, out_h) if tr else (out_h, out_w)
    cross_len = h if tr else w
    fm, lm = it[:om], it[om:2 * om]
    fc, nc = it[2 * om:2 * om + oc], it[2 * om + oc:2 * om + 2 * oc]
    strips = it[2 * om + 2 * oc:]
    tm, tc = plan.taps_march, plan.taps_cross
    wm = ft[:om * tm].reshape(om, tm)
    wc = ft[om * tm:].reshape(oc, tc)
    img = words.transpose(1, 2) if tr else words
    chans = torch.stack([c.to(F32) for c in unpack_rgba(img)], dim=1)
    codes = torch.zeros((n, 3, om, oc), dtype=F32)
    for b in range(plan.strips):
        c0, p0, p1 = strips[3 * b: 3 * b + 3]
        cols = torch.clamp(torch.arange(c0, c0 + window), max=cross_len - 1)
        for q0 in range(0, om, fr.BAND_ROWS):
            nq = min(fr.BAND_ROWS, om - q0)
            acc = torch.zeros((ring, n, 3, window), dtype=F32)
            rows = torch.zeros((ring, n, 3, window), dtype=F32)
            y = fm[q0]
            for ob in range(0, nq, ring):
                for j in range(min(ring, nq - ob)):
                    o = ob + j
                    while y <= lm[q0 + o]:
                        v = chans[:, :, y][..., cols]
                        for k in range(ring):
                            ok = o + k
                            if ok >= nq or fm[q0 + ok] > y:
                                break
                            s = (j + k) % ring
                            acc[s] = acc[s] + v * wm[q0 + ok, y - fm[q0 + ok]]
                        y += 1
                    rows[j], acc[j] = acc[j], 0.0
                for p in range(p0, p1):
                    a = torch.zeros((ring, n, 3), dtype=F32)
                    for t in range(nc[p]):
                        a = a + rows[..., fc[p] - c0 + t] * wc[p, t]
                    nr = min(ring, nq - ob)
                    codes[:, :, q0 + ob:q0 + ob + nr, p] = a[:nr].permute(1, 2, 0)
    q = torch.clamp(torch.round(codes), 0, 255)
    if tr:
        q = q.transpose(2, 3)
    return pack_rgba(q[:, 0], q[:, 1], q[:, 2])


@pytest.mark.parametrize("size", [(64, 96, 16, 24), (40, 30, 12, 9),
                                  (37, 53, 37, 20), (37, 53, 11, 53),
                                  (20, 30, 40, 61), (33, 47, 33, 47),
                                  (150, 1000, 150, 630)], ids=str)
def test_the_kernels_march_over_its_plan_is_the_plain_version(rng, size):
    """The kernel's loops, mirrored over its plan's tables, give the plain
    version's words bit for bit: the rows' pass first, the columns' first
    (the march along the columns), one axis kept each way, an upscale
    (the ring of 16), no change, and three strips of a wide frame."""
    h, w, oh, ow = size
    words = _words(rng, 2, h, w)
    got = _march(words, oh, ow)
    want = fr.resize_words_banded_plain(words, ow, oh)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_the_plan_at_the_cells_sizes():
    """45 MP to a 2048 long edge: the rows' pass first (the march down the
    rows) landscape and along the columns portrait, the ring of 8, 17
    strips of at most 124 outputs (even counts, contiguous, each band
    inside its 512-column window), and three blocks' shared memory fit an
    SM's 227 KB."""
    plan = fr.kernel_plan(5464, 8192, 1366, 2048)
    assert (plan.transposed, plan.ring, plan.strips, plan.strip_max) == (
        0, 8, 17, 124)
    assert 24 <= plan.taps_march == plan.taps_cross <= 26
    assert 3 * plan.smem_bytes <= 227 * 1024
    it = plan.itab.tolist()
    fc, nc = it[2 * 1366:2 * 1366 + 2048], it[2 * 1366 + 2048:2 * 1366 + 4096]
    strips = [it[2 * 1366 + 4096 + 3 * i:2 * 1366 + 4096 + 3 * i + 3]
              for i in range(plan.strips)]
    assert [s[1] for s in strips] == [0] + [s[2] for s in strips[:-1]]
    assert strips[-1][2] == 2048
    for c0, p0, p1 in strips:
        assert (p1 - p0) % 2 == 0 and c0 == fc[p0]
        assert all(c0 <= fc[p] and fc[p] + nc[p] <= c0 + 512
                   for p in range(p0, p1))
    portrait = fr.kernel_plan(8192, 5464, 2048, 1366)
    assert portrait.transposed == 1 and portrait.ring == 8


def test_the_plan_takes_an_upscale_to_its_ring_and_refuses_beyond():
    """An upscale to about 2.5x takes the ring of 16; beyond it the march
    refuses and the plan gives ``resize_taps`` (ring 0, no strips)."""
    assert fr.kernel_plan(200, 300, 397, 611).ring == 16
    plan = fr.kernel_plan(50, 60, 200, 240)
    assert (plan.ring, plan.strips, plan.strip_max, plan.smem_bytes) == (
        0, 0, 0, 0)
    with pytest.raises(ValueError, match="method"):
        fr.kernel_plan(64, 96, 16, 24, method="cubic")


@pytest.mark.parametrize("long_edge, ring", [(2048, 8), (128, 8), (112, 8),
                                             (110, 0), (64, 0), (8, 0)])
def test_the_plan_at_a_45_mp_frames_thumbnails(long_edge, ring):
    """Two cross bands of a strip fit the march's 512-column window to
    about 73:1 (a 112 long edge of 8192 columns); beyond it the plan
    gives ``resize_taps``, whose tables are the march's without the
    strips, landscape and portrait."""
    for h, w in ((5464, 8192), (8192, 5464)):
        oh, ow = rs.long_edge_shape(h, w, long_edge)
        plan = fr.kernel_plan(h, w, oh, ow)
        assert plan.ring == ring
        om, oc = (ow, oh) if plan.transposed else (oh, ow)
        assert plan.itab.numel() == 2 * om + 2 * oc + 3 * plan.strips
        assert plan.ftab.numel() == om * plan.taps_march + oc * plan.taps_cross


def _taps(words, out_h, out_w):
    """csrc/resize.cu's ``resize_taps`` over a ring-0 plan's tables in
    Python, f32 elementwise: each output's march band summed at every
    cross input of its band, then the cross band, both in ascending
    index. Returns (N, out_h, out_w) words."""
    n, h, w = words.shape
    plan = fr.kernel_plan(h, w, out_h, out_w)
    assert plan.ring == 0
    it, ft, tr = plan.itab.tolist(), plan.ftab, plan.transposed
    om, oc = (out_w, out_h) if tr else (out_h, out_w)
    fm, lm = it[:om], it[om:2 * om]
    fc, nc = it[2 * om:2 * om + oc], it[2 * om + oc:]
    tm, tc = plan.taps_march, plan.taps_cross
    wm = ft[:om * tm].reshape(om, tm)
    wc = ft[om * tm:].reshape(oc, tc)
    img = words.transpose(1, 2) if tr else words
    chans = torch.stack([c.to(F32) for c in unpack_rgba(img)], dim=1)
    codes = torch.zeros((n, 3, om, oc), dtype=F32)
    for m in range(om):
        inter = torch.zeros((n, 3, chans.shape[-1]), dtype=F32)
        for t in range(lm[m] - fm[m] + 1):
            inter = inter + chans[:, :, fm[m] + t] * wm[m, t]
        for p in range(oc):
            acc = torch.zeros((n, 3), dtype=F32)
            for s in range(nc[p]):
                acc = acc + inter[..., fc[p] + s] * wc[p, s]
            codes[:, :, m, p] = acc
    q = torch.clamp(torch.round(codes), 0, 255)
    if tr:
        q = q.transpose(2, 3)
    return pack_rgba(q[:, 0], q[:, 1], q[:, 2])


@pytest.mark.parametrize("size", [(120, 1600, 2, 16), (121, 1500, 3, 15),
                                  (1600, 120, 16, 2), (30, 40, 120, 160)],
                         ids=str)
def test_resize_taps_over_its_plan_is_the_plain_version(rng, size):
    """The fallback's loops, mirrored over its plan's tables, give the
    plain version's words bit for bit: 100:1 on the cross axis, odd
    outputs, a portrait frame (its march along the columns), and a 4x
    upscale beyond the ring."""
    h, w, oh, ow = size
    words = _words(rng, 2, h, w)
    got = _taps(words, oh, ow)
    want = fr.resize_words_banded_plain(words, ow, oh)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -- the wrapper, the launcher and the source --------------------------------------

def test_the_wrapper_and_the_launcher_check_their_inputs(rng):
    words = _words(rng, 2, 16, 24)
    with pytest.raises(TypeError, match="uint32"):
        fr.resize_words(words.view(torch.int32), 12, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fr.resize_words(words.transpose(1, 2), 8, 12)
    with pytest.raises(ValueError, match="even"):
        fr.resize_words(words, 12, 7, output="ycbcr420")
    with pytest.raises(ValueError, match="output"):
        fr.resize_words(words, 12, 8, output="rgb")
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        fr.resize_words(words[None], 12, 8)
    before = dict(fr.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fr.launch_resize(words, 12, 8)
    fr.resize_words(words, 12, 8)
    assert fr.LAUNCHES == before


def test_a_strided_crop_resizes_as_its_copy(rng):
    """A pure crop is a strided view (``geometry._rotate_crop``): the
    engine's ``shape_output`` and ``resize_rgba_words`` take it through
    the wrapper as they take its contiguous copy."""
    from raweditor_tpu_torch.ops import geometry

    words = _words(rng, 90, 130)
    crop = (7, 5, 101, 71)
    view = words[5:76, 7:108]
    assert not view.is_contiguous()
    want = fr.resize_words(view.contiguous(), 48, 34)
    for got in (rs.resize_rgba_words(view, 48, 34),
                geometry.shape_output(words, "words", 48, 0.0, crop)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_the_launcher_signature_matches_the_source():
    import ctypes

    decl = re.search(r'extern "C" int rtt_resize_launch\(([^)]*)\)',
                     SOURCE).group(1)
    kinds = ["ptr" if "*" in p else "int" for p in decl.split(",")]
    assert kinds == ["ptr"] * 6 + ["int"] * 13 + ["ptr"]
    assert _build.SIGNATURES["rtt_resize_launch"] == (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p])


def test_the_kernel_constants_match_the_plan():
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
    assert int(consts["kThreads"]) == fr.THREADS
    assert int(consts["kBandRows"]) == fr.BAND_ROWS
    assert "ring == 8" in SOURCE and "launch_output<8, 2>" in SOURCE
    assert "launch_output<16, 1>" in SOURCE
    assert fr.COLUMNS == {8: 2, 16: 1}


def test_the_kernel_name_lies_outside_the_benchmarks_port_kernels():
    """The output stage's readers take every kernel whose name holds none
    of ``PORT_KERNELS`` as the stage's: the kernel's name, template and
    parameter types hold none, so its time is read as the stage's."""
    kernels = re.findall(r"__global__[^{]*", SOURCE)
    assert len(kernels) == 2 and "resize_bands(" in kernels[0]
    assert "resize_taps(" in kernels[1]
    for name in PORT_KERNELS:
        for kernel in kernels:
            assert name not in kernel + " Outputs"
        assert name not in "(anonymous namespace)::resize_bands<8, 2, true>"
        assert name not in "(anonymous namespace)::resize_taps<true>"


# -- the exporter ----------------------------------------------------------------

def _files(tmp_path, rng, n=3, shape=(48, 72)):
    paths = []
    for i in range(n):
        p = tmp_path / f"r{i}.dng"
        synth.write_synthetic_raw(
            p, rng.integers(0, 4096, size=shape, dtype=np.uint16),
            black_level=150, white_level=4095, wb_neutral=(0.5, 1.0, 0.625),
            preview_jpeg=b"")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("kw, out", [
    (dict(long_edge=24), (16, 24)), (dict(long_edge=24, rotate=2.0), None),
    (dict(rotate=2.0), None)], ids=["long_edge", "rotate_long_edge",
                                    "rotate"])
def test_a_shaped_flush_resizes_once_and_counts_the_kernel_where_it_ran(
        tmp_path, rng, monkeypatch, kw, out):
    """One resize a shaped flush, over the whole (n, H, W) batch, after
    the geometry image by image; the ``shape.*`` counters as before;
    ``resize.kernel_images`` only where the kernel ran, so none on the
    CPU. Each file equals the engine's export of its job."""
    from raweditor_tpu_torch import DevelopEngine

    paths = _files(tmp_path, rng)
    calls = []
    real = fr.resize_words

    def counted(words, *args, **kwargs):
        calls.append(tuple(words.shape))
        return real(words, *args, **kwargs)

    monkeypatch.setattr(fr, "resize_words", counted)
    jobs = [pex.ExportJob(p, str(tmp_path / "out" / f"{i}.jpg"),
                          EditParams(exposure=0.1 * i))
            for i, p in enumerate(paths)]
    rep = pex.run_batch_export(jobs, device="cpu", use_kernel=True,
                               batch_size=4, mode="accurate",
                               demosaic_method="grad", **kw)
    assert rep.succeeded == 3, rep.failed
    counters = rep.stages["counters"]
    assert counters["shape.images"] == 3
    assert counters["shape.in_pixels"] == 3 * 48 * 72
    assert "resize.kernel_images" not in counters
    if "long_edge" in kw:
        assert len(calls) == 1 and calls[0][0] == 3
    else:
        assert calls == []
    if out is not None:
        assert counters["shape.out_pixels"] == 3 * out[0] * out[1]
    monkeypatch.undo()
    for job in jobs:
        eng = DevelopEngine.open(job.raw_path, "accurate", device="cpu",
                                 use_kernel=True, demosaic_method="grad")
        ref = eng.export(tmp_path / "engine.jpg", job.params, quality=95,
                         **kw)
        assert open(ref, "rb").read() == open(job.out_path, "rb").read()
