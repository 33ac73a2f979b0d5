"""The least time a frame's develop work needs on one H100: f32
operations counted in the kernels' source over 67 TFLOP/s, or bytes
(each read or written once) over 3.35 TB/s, whichever is larger. An
FMA counts as two operations and the transfer's operations are
counted though the kernels look them up in a table, so the bound
overstates the reachable.

Each span below is copied verbatim from ``chip_smoke.py`` at commit
e13d09fb7b94 (the comment before it names the lines);
``bench_torch/tests/test_copies.py`` holds them equal."""

# chip_smoke.py:265-289
# The bound: H100 SXM data-sheet rates (HBM, f32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per pixel, counted in the kernels' source with each
# shared subexpression once and averaged over the four Bayer sites;
# powf, sqrtf and a division count one each, so this is a lower bound.
DEMOSAIC_OPS = {"nearest": 1.0,    # raw * scale
                "bilinear": 7.0,   # + the neighbour sums and means
                "malvar": 24.5,    # + the four 5x5 filters, 3 floors
                "grad": 52.0,      # G 8.5, R/B 6.5, 2 refinements 36
                # The generic-CFA tiers (cfa_nearest, cfa_smooth,
                # cfa_grad) are counted from the pattern itself by
                # cfa_demosaic_ops() when the run starts.
                }
FINISH_OPS = 60.0                  # matrix, tone, saturation/vibrance
QUANT_OPS = {"pow": 6.0, "poly": 18.0, "srgb": 10.0, "srgb_poly": 20.0}
YCBCR_OPS = 23.5                   # Y, Cb, Cr and the 2x2 chroma box
# The extras kernel per output pixel (csrc/extras.cu, halo recompute not
# counted): unpack and quantise 12; the stencil stages 172 (two chroma
# tents 28, chroma blend 6, the bilateral's 8 taps 69, tone curve 28,
# vignette 11, sharpen 10, split/rebuild 14, clamps 6); the mixer 200
# (hue 23, nine hats 63, three interpolations 51, back-convert and blend
# 63); grading 56.
EXTRAS_OPS = {"io": 12.0, "stencils": 172.0, "mixer": 200.0,
              "grading": 56.0}


# chip_smoke.py:351-432
def cfa_demosaic_ops(grid):
    """f32 operations per pixel that the generic-CFA demosaics need on the
    channel grid ``grid`` (side x side of 0/1/2 = R/G/B), averaged over the
    period's cells: {"cfa_nearest", "cfa_smooth", "cfa_grad"}.

    Only the taps the pattern fills are counted. A masked tap is an exact
    zero, and adding it, doubling it or dividing by a denominator of one
    changes no bit, so a kernel need not do it; the kernels' factored
    order (column sums (a + b*2) + c, then the row sum) is kept, a select
    and an abs are free, a division counts one."""
    side = grid.shape[0]
    tent_w = (1, 2, 1)

    def at(y, x, chan):
        return bool(grid[y % side, x % side] == chan)

    def sum3(a, b, c):
        """(ops, nonzero) of (a + b*2) + c over known-zero flags."""
        return int(b) + int(a and b) + int((a or b) and c), a or b or c

    def tent2(y, x, chan):
        """The masked 3x3 tent of ``chan`` around (y, x), its division
        included."""
        ops, cols, den = 0, [], 0
        for dx in (-1, 0, 1):
            fill = [at(y + dy, x + dx, chan) for dy in (-1, 0, 1)]
            n, nz = sum3(*fill)
            ops += n
            cols.append(nz)
            den += tent_w[dx + 1] * sum(w for w, f in zip(tent_w, fill) if f)
        n, nz = sum3(*cols)
        return ops + n + int(nz and den != 1)

    def tent1(y, x, dy, dx):
        """The masked 1-D G tent along (dy, dx) at a non-G cell: (ops,
        nonzero)."""
        a, c = at(y - dy, x - dx, 1), at(y + dy, x + dx, 1)
        return int(a and c) + int(a + c > 1), a or c

    smooth = grad = 0
    for y in range(side):
        for x in range(side):
            here = int(grid[y, x])
            smooth += sum(tent2(y, x, c) for c in range(3) if c != here)
            if here != 1:
                # G: the two directional tents, the two gradient weights
                # (sub, add, div), the blend (two products, their sum,
                # the weights' sum, the division); then value - G.
                (nh, zh), (nv, zv) = tent1(y, x, 0, 1), tent1(y, x, 1, 0)
                grad += nh + nv + 6 + int(zh) + int(zv) + int(zh and zv) + 2
                grad += 1
            # R and B where missing: the tent of value - G, then + G.
            grad += sum(tent2(y, x, c) + 1 for c in (0, 2) if c != here)
    cells = float(side * side)
    # cfa_nearest: raw * scale; cfa_grad: + the two chroma refinements on
    # dense planes, 36 as for the Bayer kernel.
    return {"cfa_nearest": 1.0, "cfa_smooth": 1.0 + smooth / cells,
            "cfa_grad": 1.0 + grad / cells + 36.0}


def bound(n_px, demosaic, gamma, output):
    """(ms, "bytes" or "operations"): the least time the card could take
    for ``n_px`` pixels of one kernel variant."""
    out_bytes = 4.0 if output == "rgba" else 1.5
    ops = (DEMOSAIC_OPS[demosaic] + FINISH_OPS + 3 * QUANT_OPS[gamma]
           + (YCBCR_OPS if output == "ycbcr420" else 0.0))
    t_bytes = n_px * (2.0 + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def extras_bound(n_px, mixer_on, grading_on, stencils, output):
    """(ms, "bytes" or "operations") for the extras kernel: 4 B/px read,
    4 (RGBA) or 1.5 (planes) B/px written."""
    ops = (EXTRAS_OPS["io"] + EXTRAS_OPS["stencils"] * stencils
           + EXTRAS_OPS["mixer"] * mixer_on
           + EXTRAS_OPS["grading"] * grading_on
           + (YCBCR_OPS if output == "ycbcr420" else 0.0))
    out_bytes = 4.0 if output == "rgba" else 1.5
    t_bytes = n_px * (4.0 + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
