"""The picture and the edits the traffic is made of.

Each span below is copied verbatim from ``chip_smoke.py`` at commit
e13d09fb7b94 (the comment before it names the lines);
``bench_torch/tests/test_copies.py`` holds them equal."""

import numpy as np

# chip_smoke.py:233-240
# The extras path's edit: every band-local extra, six mixer sliders and
# two grading wheels.
XEDIT = dict(sharpen=60.0, denoise=40.0, curve_shadows=30.0,
             curve_darks=-20.0, curve_lights=15.0, curve_highlights=-40.0,
             vignette=-30.0, hue_red=25.0, hue_orange=-15.0, sat_yellow=30.0,
             sat_blue=-40.0, lum_green=35.0, lum_magenta=-25.0,
             grade_shadow_hue=210.0, grade_shadow_sat=40.0,
             grade_high_hue=45.0, grade_high_sat=30.0)

# chip_smoke.py:258-263
# Nikon D3300 ColorMatrix (dcraw adobe_coeff, x10000) for the accurate frame.
D3300_XYZ_TO_CAM = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                             [-1485, 2204, 7318]], np.float32) / 10000.0
# Fujifilm X-T2 (X-Trans III) ColorMatrix, the same source.
XT2_XYZ_TO_CAM = np.array([[11434, -4948, -1210], [-3746, 12042, 1903],
                           [-666, 1479, 5235]], np.float32) / 10000.0


# chip_smoke.py:644-656
def scene(rng, h, w, top):
    """A seeded picture rather than noise, as u16 samples in 0..top: smooth
    gradients, discs of flat tone and about 1% noise."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = 0.1 + 0.45 * x + 0.3 * y * (1.0 - x)
    for _ in range(6):
        cy, cx = rng.uniform(0.1, 0.9, 2)
        r = rng.uniform(0.04, 0.15)
        disc = (y - np.float32(cy)) ** 2 + ((x - np.float32(cx)) * (w / h)) ** 2
        img = np.where(disc < r * r, np.float32(rng.uniform(0.05, 0.95)), img)
    img += rng.standard_normal((h, w), dtype=np.float32) * np.float32(0.01)
    return np.clip(img * top, 0, top).astype(np.uint16)
