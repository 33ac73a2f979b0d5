#!/usr/bin/env python3
"""Time variants of the hand-written develop, extras and staging kernels
against each other on the card, in turns inside one process.

    python3 -m raweditor_tpu_torch.tools.kernel_ab \
        --variant parent=build/parent/raweditor_tpu_torch/csrc \
        --variant new=raweditor_tpu_torch/csrc [--variant NAME=DIR,-DX=1 ...] \
        [--cases B8,B5,B6,S] [--sass NAME ...] [--rounds 4] [--reps 5] [--out DIR]

Each ``--variant`` names a directory that holds the kernel sources and
their headers (for an earlier commit:
``git archive <commit> raweditor_tpu_torch/csrc | tar -x -C build/parent``),
optionally followed by ``nvcc`` defines. The develop launchers of a
variant take the transfer's quantiser table on the device (the current
interface, ``_build.SIGNATURES``; the table is derived once per transfer)
or, in sources from before that interface, the transfer's code
(``CODE_SIGNATURES``); ``takes_table`` reads which from ``develop.cu``. ``--cases`` picks the cases of
``CASES`` and ``STAGING_CASES`` whose names start with one of the given
prefixes (default: all).
For every variant only the sources those cases launch are built, with the
package's flags plus ``-Xptxas -v``, into a library of its own under
``build/kernel_ab/`` (all ``nvcc`` processes started together), loaded with
``ctypes`` and launched through the kernels' C interface on the shapes
``chip_smoke.py`` times:

- B1/B2 (Bayer nearest, the 1/2.2 power transfer), B3 (bilinear and
  Malvar) and B4 (Bayer grad) on a 4016x6016 frame and B7, B5, B6 (the
  generic-CFA grad, nearest and smooth kernels on the X-Trans grid) on
  4000x6000: one frame to RGBA words and four frames to YCbCr 4:2:0
  planes, the sRGB transfer unless the case names another, seeded 12-bit
  data;
- B8 (finish extras) on seeded 24-bit words with alpha 255 at 4016x6016:
  one frame to RGBA words with all three flags on, with the stencils only,
  with the mixer only and in its pointwise form (mixer and grading, no
  stencils), and four frames with per-image amounts to planes;
- the staging kernel (``csrc/staging.cu``, ``STAGING_CASES``): seeded
  packed bytes of 4016x6016 u12 and 4000x6000 u14 frames into one slot,
  and into eight slots from five sources (the last three repeat the
  first, which the kernel supports), against the plain chain the
  exporter ran before the kernel (``unpack12_rows`` or ``unpack14_rows``
  a source, then ``torch.stack``), timed as one more variant, ``plain``,
  each call queued behind a sleeping kernel so that the host's launch
  time does not enter (``time_staging``, which ``chip_smoke.py`` calls
  too). The plain chain is the parent of these cases: give them only
  variants whose directory holds ``staging.cu``. Printed beside the medians: the bound, each
  distinct source's bytes read once and every slot's written, over
  3.35 TB/s.

Device times move by up to 13% between runs, so variants are only compared
inside one run: each round times every variant (CUDA events, ``--reps``
launches after a warm-up), the order reversed every other round. Printed
per case: each variant's median (a ``*`` where its output differs from the
first variant's), then one JSON line with median, min and max, beside the
card's name and power limit. For each variant also the registers, shared
memory and spills ``ptxas`` reports for the instantiations the RGBA cases
launch, and for ``--sass`` variants the ``cuobjdump -sass`` instruction
count per class (the full listing goes to ``sass_NAME.txt`` under
``--out``, the JSON record to ``kernel_ab_TAG.json`` there; default
``build/kernel_ab``).
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "kernel_ab")
H, W = 4016, 6016
XH, XW = 4000, 6000

# The source that defines each launcher of the C interface.
SOURCES = {"rtt_develop_launch": "develop.cu",
           "rtt_develop_grad_launch": "develop_grad.cu",
           "rtt_develop_grad_cfa_launch": "develop_grad_generic.cu",
           "rtt_develop_cfa_launch": "develop.cu",
           "rtt_extras_launch": "extras.cu",
           "rtt_unpack_slots_launch": "staging.cu"}
# Mangled template arguments of the instantiations the RGBA cases launch,
# per source: output to words, and before the quantiser table the
# transfer too (sRGB; the Bayer quad kernel's nearest: the power
# transfer); for the extras every flag set.
INSTANCES = {"develop_grad.cu": ("bandsILb0E", "Li2ELb0E"),
             "develop_grad_generic.cu": ("bandsILb0E", "Li2ELb0E"),
             "develop.cu": ("cfaILb0E", "quadsILb0ELi", "cfaILi2ELb0E",
                            "quadsILi0ELb0ELi0E", "quadsILi2ELb0ELi1E",
                            "quadsILi2ELb0ELi2E"),
             "extras.cu": ("ILb1ELb1ELb1ELb0E", "bandsILb1ELb1ELb0E"),
             "staging.cu": ("unpack_slots",)}
# name: launcher, frames, output (0 words, 1 planes), then per kind the
# transfer (``gamma``, the C interface's code; default 2, sRGB), the
# demosaic (Bayer quad kernel: 0 nearest, 1 bilinear, 2 Malvar;
# generic-CFA quad kernel: 0 nearest, 1 smooth) or the extras flags
# (mixer, grading, stencils).
CASES = {
    "B1_rgba": dict(launcher="rtt_develop_launch", frames=1, output=0,
                    gamma=0, demosaic=0),
    "B2_planes": dict(launcher="rtt_develop_launch", frames=4, output=1,
                      gamma=0, demosaic=0),
    "B3_bilinear_rgba": dict(launcher="rtt_develop_launch", frames=1,
                             output=0, demosaic=1),
    "B3_bilinear_planes": dict(launcher="rtt_develop_launch", frames=4,
                               output=1, demosaic=1),
    "B3_malvar_rgba": dict(launcher="rtt_develop_launch", frames=1, output=0,
                           demosaic=2),
    "B3_malvar_planes": dict(launcher="rtt_develop_launch", frames=4,
                             output=1, demosaic=2),
    "B4_rgba": dict(launcher="rtt_develop_grad_launch", frames=1, output=0),
    "B4_planes": dict(launcher="rtt_develop_grad_launch", frames=4, output=1),
    "B7_rgba": dict(launcher="rtt_develop_grad_cfa_launch", frames=1,
                    output=0),
    "B7_planes": dict(launcher="rtt_develop_grad_cfa_launch", frames=4,
                      output=1),
    "B5_rgba": dict(launcher="rtt_develop_cfa_launch", frames=1, output=0,
                    demosaic=0),
    "B5_planes": dict(launcher="rtt_develop_cfa_launch", frames=4, output=1,
                      demosaic=0),
    "B6_rgba": dict(launcher="rtt_develop_cfa_launch", frames=1, output=0,
                    demosaic=1),
    "B6_planes": dict(launcher="rtt_develop_cfa_launch", frames=4, output=1,
                      demosaic=1),
    "B8_rgba": dict(launcher="rtt_extras_launch", frames=1, output=0,
                    flags=(1, 1, 1)),
    "B8_rgba_stencils": dict(launcher="rtt_extras_launch", frames=1,
                             output=0, flags=(0, 0, 1)),
    "B8_rgba_mixer": dict(launcher="rtt_extras_launch", frames=1, output=0,
                          flags=(1, 0, 0)),
    "B8_rgba_pointwise": dict(launcher="rtt_extras_launch", frames=1,
                              output=0, flags=(1, 1, 0)),
    "B8_planes": dict(launcher="rtt_extras_launch", frames=4, output=1,
                      flags=(1, 1, 1)),
}
# The staging kernel's cases: the source format, the frame, the slots
# filled and the distinct sources they are filled from (the rest replay
# the first).
STAGING_CASES = {
    "S_u12_1": dict(launcher="rtt_unpack_slots_launch", fmt="u12",
                    frame=(H, W), slots=1, sources=1),
    "S_u12_8": dict(launcher="rtt_unpack_slots_launch", fmt="u12",
                    frame=(H, W), slots=8, sources=5),
    "S_u14_1": dict(launcher="rtt_unpack_slots_launch", fmt="u14",
                    frame=(XH, XW), slots=1, sources=1),
    "S_u14_8": dict(launcher="rtt_unpack_slots_launch", fmt="u14",
                    frame=(XH, XW), slots=8, sources=5),
}
HBM_BYTES_PER_S = 3.35e12
# The develop launchers' C signatures before they took the quantiser
# table (the transfer's code in its place: 0 pow, 1 poly, 2 srgb,
# 3 srgb_poly), for a variant built from an earlier commit.
CODE_SIGNATURES = {
    "rtt_develop_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "rtt_develop_grad_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "rtt_develop_cfa_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_char_p, ctypes.c_void_p],
    "rtt_develop_grad_cfa_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_char_p, ctypes.c_void_p],
}
GAMMA_NAMES = ("pow", "poly", "srgb", "srgb_poly")

# The extras cases' edit (every band-local extra, six mixer sliders, two
# grading wheels) and the other three images of the planes batch.
XEDIT = dict(sharpen=60.0, denoise=40.0, curve_shadows=30.0,
             curve_darks=-20.0, curve_lights=15.0, curve_highlights=-40.0,
             vignette=-30.0, hue_red=25.0, hue_orange=-15.0, sat_yellow=30.0,
             sat_blue=-40.0, lum_green=35.0, lum_magenta=-25.0,
             grade_shadow_hue=210.0, grade_shadow_sat=40.0,
             grade_high_hue=45.0, grade_high_sat=30.0)
MIXER_ONLY = dict(hue_red=25.0, hue_orange=-15.0, sat_yellow=30.0,
                  sat_blue=-40.0, lum_green=35.0, lum_magenta=-25.0)


def pick_cases(prefixes):
    """The cases whose names start with one of ``prefixes`` (all of them
    for none), in the tables' order."""
    known = list(CASES) + list(STAGING_CASES)
    names = [c for c in known
             if not prefixes or any(c.startswith(p) for p in prefixes)]
    if not names:
        raise SystemExit(f"no case matches {prefixes}; known: {known}")
    return names


def spec_of(name):
    """The case ``name`` of ``CASES`` or ``STAGING_CASES``."""
    return CASES[name] if name in CASES else STAGING_CASES[name]


def sources_for(case_names):
    """The sources that define the launchers of ``case_names``, sorted."""
    return sorted({SOURCES[spec_of(c)["launcher"]] for c in case_names})


def build_all(variants, sources):
    """Compile ``sources`` of every variant (all nvcc processes at once)
    and link one library per variant; keeps ptxas' report per source."""
    from raweditor_tpu_torch.ops import _build

    nvcc, flags = _build._nvcc(), list(_build.NVCC_FLAGS)
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for v in variants:
        d = os.path.join(ROOT, v["dir"])
        for src in sources:
            o = os.path.join(OUT, f"{v['name']}.{src}.o")
            cmd = [nvcc, *flags, "-Xptxas", "-v", *v.get("defs", []), "-c",
                   os.path.join(d, src), "-o", o]
            procs.append((v, src, o, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for v, src, o, p in procs:
        out = p.communicate()[0]
        if p.returncode:
            print(out)
            raise SystemExit(f"nvcc failed for {v['name']} {src}")
        v.setdefault("ptxas", {})[src] = out
    for v in variants:
        objs = [os.path.join(OUT, f"{v['name']}.{s}.o") for s in sources]
        so = os.path.join(OUT, f"{v['name']}.so")
        subprocess.run([nvcc, *flags, "-shared", *objs, "-o", so], check=True)
        v["so"] = so


def takes_table(src_dir):
    """Whether the develop launchers in ``src_dir`` take the quantiser
    table (else the transfer's code, as before that interface)."""
    text = open(os.path.join(src_dir, "develop.cu")).read()
    head = text[text.index('extern "C" int rtt_develop_launch('):]
    return "quant" in head[:head.index(")")]


def declare(lib, launchers, table):
    """``lib`` with the C signatures of ``launchers`` declared, those of
    the code interface where the variant does not take the table."""
    from raweditor_tpu_torch.ops import _build

    _build.declare(lib, launchers)
    if not table:
        for name in set(launchers) & set(CODE_SIGNATURES):
            getattr(lib, name).argtypes = CODE_SIGNATURES[name]
    return lib


def ptxas_summary(text, picks=("Li2E",)):
    """Lines 'registers/smem/spill' of ptxas' report ``text`` for the entry
    functions whose mangled name holds one of ``picks``."""
    lines = text.splitlines()
    res = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and any(p in ln for p in picks):
            name = ln.split("'")[1]
            blob = " ".join(lines[i + 1:i + 4])
            res.append(f"    {name}: {blob.strip()}")
    return "\n".join(res)


def sass_counts(so, outpath):
    """{kernel: {instruction class: count}} of a library's SASS, whose
    full listing is written to ``outpath``."""
    from raweditor_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    with open(outpath, "w") as f:
        f.write(txt)
    res = {}
    cur = None
    for ln in txt.splitlines():
        ln = ln.strip()
        if ln.startswith("Function :"):
            cur = ln.split(":", 1)[1].strip()
            res[cur] = {}
            continue
        if cur is None or not ln.startswith("/*") or ";" not in ln:
            continue
        # /*0000*/   INSTR ... ;
        body = ln.split("*/", 1)[1].strip()
        if body.startswith("/*"):
            continue
        toks = body.split()
        if not toks:
            continue
        op = toks[0]
        if op.startswith("@"):
            op = toks[1] if len(toks) > 1 else op
        op = op.rstrip(";")
        base = op.split(".")[0]
        cls = classify(base)
        res[cur][cls] = res[cur].get(cls, 0) + 1
        res[cur]["total"] = res[cur].get("total", 0) + 1
    return res


def classify(b):
    """The class of one SASS opcode (its part before the first dot)."""
    if b in ("LDS", "LDSM"):
        return "LDS"
    if b == "STS":
        return "STS"
    if b in ("LDG", "LD", "LDC", "ULDC", "STG", "ST"):
        return "GMEM/const"
    if b == "BAR":
        return "BAR"
    if b.startswith("MUFU"):
        return "MUFU"
    if b in ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET",
             "FCHK", "F2I", "I2F", "F2F", "FRND", "I2FP", "F2IP"):
        return "f32"
    if b in ("IMAD", "IADD3", "LEA", "LOP3", "SHF", "ISETP", "IABS", "IMNMX",
             "VIMNMX", "PRMT", "SEL", "MOV", "SGXT", "BMSK", "PLOP3", "UIADD3",
             "UIMAD", "ULOP3", "USHF", "UISETP", "UMOV", "ULEA", "S2R", "S2UR",
             "CS2R", "R2UR", "IDP", "POPC", "FLO", "UFLO", "USEL", "P2R",
             "R2P", "UPRMT", "UPLOP3", "VOTE", "VOTEU", "SHFL", "I2I", "I2IP"):
        return "SHFL" if b == "SHFL" else "int/move"
    if b in ("BRA", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "WARPSYNC", "NOP",
             "BRX", "JMP", "YIELD", "BREAK", "BMOV", "DEPBAR", "ERRBAR"):
        return "NOP" if b == "NOP" else "control"
    return "other:" + b


def cuda_ms(fn, reps):
    """Per-run milliseconds (CUDA events) of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def queued_ms(fn, reps, loop=20):
    """Per-call milliseconds (CUDA events) of ``fn`` after one warm-up,
    ``loop`` calls queued behind a sleeping kernel: the host's time to
    launch them does not enter a kernel shorter than it."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(loop):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / loop)
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    metavar="NAME=DIR[,-DX=1...]")
    ap.add_argument("--sass", action="append", default=[], metavar="NAME")
    ap.add_argument("--cases", default="", metavar="PREFIX[,PREFIX...]",
                    help="case name prefixes, e.g. B8,B5 (default: all)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tag", default="run", help="names the JSON record")
    ap.add_argument("--out", default=OUT,
                    help="directory of the record and the SASS listings")
    args = ap.parse_args(argv)
    args.cases = pick_cases([p for p in args.cases.split(",") if p])
    variants = []
    for spec in args.variant:
        name, _, rest = spec.partition("=")
        where, *defs = rest.split(",")
        variants.append({"name": name, "dir": where, "defs": defs})
    return args, variants


def make_inputs(case_names):
    """The device inputs the cases need, by launcher: seeded, the same for
    every variant."""
    from raweditor_tpu_torch import EditParams
    from raweditor_tpu_torch.color import cam_to_srgb_matrix
    from raweditor_tpu_torch.ops import fused_develop as fused
    from raweditor_tpu_torch.ops import fused_extras as fx
    from raweditor_tpu_torch.parallel.batch import pack_params

    launchers = {CASES[c]["launcher"] for c in case_names}
    inputs = {}
    edit = EditParams(exposure=0.4, contrast=6.0, highlights=-0.3,
                      shadows=0.25, whites=1.05, blacks=0.03,
                      saturation=20.0, vibrance=0.4, temperature=0.1,
                      tint=-0.05)
    if launchers - {"rtt_extras_launch"}:
        D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                          [-1485, 2204, 7318]], np.float32) / 10000.0
        rng = np.random.default_rng(20261016)
        batch = torch.from_numpy(
            rng.integers(0, 4096, size=(4, H, W), dtype=np.uint16)).cuda()
        params = [edit, EditParams(),
                  EditParams(exposure=-1.2, saturation=-40.0),
                  EditParams(exposure=1.1, contrast=-5.0, vibrance=-0.5,
                             temperature=-0.3)]
        wb = np.array([[2.0, 1.0, 1.5], [1.8, 1.0, 1.4], [2.2, 1.0, 1.3],
                       [1.0, 1.0, 1.0]], np.float32)
        cm = np.tile(cam_to_srgb_matrix(D3300, "accurate"), (4, 1, 1))
        scal = pack_params(params, wb, cm, matrix_transpose=False,
                           white_levels=[4095.0, 4095.0, 4000.0, 16383.0],
                           black_levels=[150.0, 150.0, 64.0, 512.0]).cuda()
        inputs["rtt_develop_launch"] = (batch, scal)
        inputs["rtt_develop_grad_launch"] = (batch, scal)
        xt = batch[:, :XH, :XW].contiguous()
        for name in SOURCES:
            if "cfa" in name:
                inputs[name] = (xt, scal)
        inputs["tables"] = fused.cfa_tables(
            fused.cfa_generic.XTRANS_PATTERN).packed
    if "rtt_extras_launch" in launchers:
        gen = torch.Generator(device="cuda").manual_seed(20261016)
        words = (torch.randint(0, 2 ** 24, (4, H, W), generator=gen,
                               device="cuda", dtype=torch.int32)
                 | torch.tensor(-(2 ** 24), dtype=torch.int32, device="cuda")
                 ).view(torch.uint32)
        xedit = edit.replace(**XEDIT)
        table = fx.pack_extras([
            xedit, EditParams(), edit.replace(**MIXER_ONLY),
            EditParams(sharpen=100.0, vignette=50.0, grade_mid_hue=120.0,
                       grade_mid_sat=-40.0)])[0].cuda()
        inputs["rtt_extras_launch"] = (words, table)
    return inputs


def runner(lib, case, inputs, stream, table=True):
    """(launch closure, outputs) of one case on one variant's library;
    ``table``: the variant's develop launchers take the quantiser table."""
    from raweditor_tpu_torch.ops import fused_develop as fused
    from raweditor_tpu_torch.ops.extras import radial_consts

    data, side = inputs[case["launcher"]]
    n, output = case["frames"], case["output"]
    data, side = data[:n].contiguous(), side[:n].contiguous()
    _, h, w = data.shape
    dev = data.device
    if output == 0:
        out0 = torch.empty((n, h, w), dtype=torch.uint32, device=dev)
        out1 = None
    else:
        out0 = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
        out1 = torch.empty((n, h // 2, w), dtype=torch.uint8, device=dev)
    name = case["launcher"]
    gamma = case.get("gamma", 2)
    if name != "rtt_extras_launch":
        quant = fused.quant_table(GAMMA_NAMES[gamma], dev)[1].data_ptr()
    if name == "rtt_develop_launch":
        tail = ((0, 0, output, case["demosaic"], quant, stream) if table
                else (0, 0, gamma, output, case["demosaic"], stream))
    elif name == "rtt_develop_grad_launch":
        tail = ((0, 0, output, quant, stream) if table
                else (0, 0, gamma, output, stream))
    elif name == "rtt_develop_grad_cfa_launch":
        tail = ((output, inputs["tables"], quant, stream) if table
                else (gamma, output, inputs["tables"], stream))
    elif name == "rtt_develop_cfa_launch":
        tail = ((output, case["demosaic"], inputs["tables"], quant, stream)
                if table else (gamma, output, case["demosaic"],
                               inputs["tables"], stream))
    else:
        consts = [float(v) for v in radial_consts(h, w)]
        tail = (*case["flags"], output, *consts, stream)
    fn = getattr(lib, name)

    def go():
        code = fn(data.data_ptr(), side.data_ptr(), out0.data_ptr(),
                  None if out1 is None else out1.data_ptr(), n, h, w, *tail)
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")
    return go, (out0, out1)


def staging_runner(lib, case, bufs, out, stream):
    """(launch closure, outputs) of a staging case on a library that
    holds the staging kernel: every slot of ``out`` from ``bufs``, the
    slots past them from the first."""
    from raweditor_tpu_torch.ops import staging

    n = case["slots"]
    srcs = [bufs[i] if i < len(bufs) else bufs[0] for i in range(n)]
    args = staging.slot_args(out, staging._check_slots(
        out, srcs, [case["fmt"]] * n))

    def go():
        code = lib.rtt_unpack_slots_launch(*args, stream)
        if code:
            raise RuntimeError(f"rtt_unpack_slots_launch: CUDA error {code}")
    return go, (out,)


def staging_inputs(case):
    """Seeded packed bytes of the case's distinct sources on the card (any
    byte pattern decodes), and its batch."""
    from raweditor_tpu_torch.ops import staging

    h, w = case["frame"]
    per, size = staging._GROUPS[case["fmt"]]
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    bufs = [torch.randint(0, 256, (h, w // per * size), generator=gen,
                          dtype=torch.uint8, device="cuda")
            for _ in range(case["sources"])]
    out = torch.empty((case["slots"], h, w), dtype=torch.uint16,
                      device="cuda")
    return bufs, out


def staging_bound_ms(case):
    """Bytes over the H100's 3.35 TB/s: each distinct source's packed
    bytes read once and every slot's u16 samples written."""
    from raweditor_tpu_torch.ops import staging

    h, w = case["frame"]
    per, size = staging._GROUPS[case["fmt"]]
    read = case["sources"] * h * (w // per * size)
    return 1e3 * (read + case["slots"] * 2 * h * w) / HBM_BYTES_PER_S


def time_staging(case, libs, stream, rounds, reps):
    """A staging case (a ``STAGING_CASES`` entry) on each library of
    ``libs`` (name: a library that holds the staging kernel) and on the
    plain chain the exporter ran before the kernel (``plain``: an unpack a
    source, then ``torch.stack``), in turns, each call queued behind a
    sleeping kernel; each library's batch against the plain chain's.
    Returns ``{name: {median, min, max, equal_to_plain, bound_ms}}``."""
    from raweditor_tpu_torch.ops import staging

    bufs, out = staging_inputs(case)
    unpack = staging._UNPACK[case["fmt"]]
    plain_out = []

    def plain():
        parts = [unpack(b) for b in bufs]
        plain_out[:] = [torch.stack(
            parts + [parts[0]] * (case["slots"] - len(parts)))]
    runs = {"plain": (plain, None)}
    for name, lib in libs.items():
        runs[name] = staging_runner(lib, case, bufs, torch.empty_like(out),
                                    stream)
    order = list(runs)
    ms = {name: [] for name in order}
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            ms[name] += queued_ms(runs[name][0], reps,
                                  4 if name == "plain" else 20)
    torch.cuda.synchronize()
    bound = staging_bound_ms(case)
    res = {name: dict(median=statistics.median(ms[name]), min=min(ms[name]),
                      max=max(ms[name]), bound_ms=bound,
                      equal_to_plain=name == "plain" or torch.equal(
                          runs[name][1][0], plain_out[0]))
           for name in order}
    del runs, plain_out, bufs, out
    torch.cuda.empty_cache()
    return res


def main(argv=None):
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    args, variants = parse_args(argv)
    sass_names = set(args.sass)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi, flush=True)
    sources = sources_for(args.cases)
    launchers = sorted({spec_of(c)["launcher"] for c in args.cases})
    t0 = time.perf_counter()
    build_all(variants, sources)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(args.out, exist_ok=True)
    for v in variants:
        print(f"== ptxas {v['name']} (the RGBA cases' instantiations)")
        for src, txt in v["ptxas"].items():
            print(f"  {src}:")
            print(ptxas_summary(txt, INSTANCES[src]))
        if v["name"] in sass_names:
            counts = sass_counts(v["so"], os.path.join(
                args.out, f"sass_{v['name']}.txt"))
            for fn, c in counts.items():
                if any(p in fn for src in sources for p in INSTANCES[src]):
                    print(f"  SASS {v['name']} {fn}: "
                          f"{json.dumps(dict(sorted(c.items())))}")
        sys.stdout.flush()
    for v in variants:
        v["table"] = takes_table(os.path.join(ROOT, v["dir"]))
        v["lib"] = declare(ctypes.CDLL(v["so"]), launchers, v["table"])

    inputs = make_inputs([c for c in args.cases if c in CASES])
    stream = torch.cuda.current_stream().cuda_stream
    rounds, reps = args.rounds, args.reps
    table = {}
    for cname in args.cases:
        if cname in STAGING_CASES:
            res = time_staging(STAGING_CASES[cname],
                               {v["name"]: v["lib"] for v in variants},
                               stream, rounds, reps)
            for name, row in res.items():
                table.setdefault(name, {})[cname] = row
            print(f"-- {cname}: " + ", ".join(
                f"{n} {r['median']:.4f}{'' if r['equal_to_plain'] else '*'}"
                for n, r in res.items())
                + f"; bound {res['plain']['bound_ms']:.4f} ms  [{smi}]",
                flush=True)
            continue
        runs = {v["name"]: runner(v["lib"], CASES[cname], inputs, stream,
                                  v["table"]) for v in variants}
        ms = {v["name"]: [] for v in variants}
        order = [v["name"] for v in variants]
        for r in range(rounds):
            seq = order if r % 2 == 0 else order[::-1]
            for name in seq:
                ms[name] += cuda_ms(runs[name][0], reps)
        torch.cuda.synchronize()
        base_out = runs[order[0]][1]
        for v in variants:
            name = v["name"]
            same = all(torch.equal(a, b) for a, b in zip(
                [t for t in runs[name][1] if t is not None],
                [t for t in base_out if t is not None]))
            table.setdefault(name, {})[cname] = dict(
                median=statistics.median(ms[name]), min=min(ms[name]),
                max=max(ms[name]), equal_to_first=same)
        print(f"-- {cname}: " + ", ".join(
            f"{n} {table[n][cname]['median']:.4f}"
            f"{'' if table[n][cname]['equal_to_first'] else '*'}"
            for n in order) + f"  [{smi}]", flush=True)
        del runs
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ab": table}))
    with open(os.path.join(args.out, f"kernel_ab_{args.tag}.json"),
              "w") as f:
        json.dump({"card": smi, "ab": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
