#!/usr/bin/env python3
"""Time variants of the two grad develop kernels against each other on
the card, in turns inside one process.

    python3 -m raweditor_tpu_torch.tools.kernel_ab \
        --variant parent=build/parent/raweditor_tpu_torch/csrc \
        --variant new=raweditor_tpu_torch/csrc [--variant NAME=DIR,-DX=1 ...] \
        [--sass NAME ...] [--rounds 4] [--reps 5] [--out DIR]

Each ``--variant`` names a directory that holds ``develop_grad.cu``,
``develop_grad_generic.cu`` and their headers (for an earlier commit:
``git archive <commit> raweditor_tpu_torch/csrc | tar -x -C build/parent``),
optionally followed by ``nvcc`` defines. Every variant is built with the
package's flags plus ``-Xptxas -v`` into a library of its own under
``build/kernel_ab/`` (all ``nvcc`` processes started together), loaded with
``ctypes`` and launched through the kernels' C interface on the shapes
``chip_smoke.py`` times: B4 (Bayer grad) on a 4016x6016 frame and B7 (the
generic-CFA grad on the X-Trans grid) on 4000x6000, one frame to RGBA words
and four frames to YCbCr 4:2:0 planes, sRGB transfer, seeded 12-bit data.

Device times move by up to 13% between runs, so variants are only compared
inside one run: each round times every variant (CUDA events, ``--reps``
launches after a warm-up), the order reversed every other round. Printed
per case: each variant's median (a ``*`` where its output differs from the
first variant's), then one JSON line with median, min and max, beside the
card's name and power limit. For each variant also the registers, shared
memory and spills ``ptxas`` reports for the sRGB instantiations, and for
``--sass`` variants the ``cuobjdump -sass`` instruction count per class
(the full listing goes to ``sass_NAME.txt`` under ``--out``, the JSON
record to ``kernel_ab_TAG.json`` there; default ``build/kernel_ab``).
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


def build_all(variants):
    """Compile both sources of every variant (all nvcc processes at once)
    and link one library per variant; keeps ptxas' report per source."""
    from raweditor_tpu_torch.ops import _build

    nvcc, flags = _build._nvcc(), list(_build.NVCC_FLAGS)
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for v in variants:
        d = os.path.join(ROOT, v["dir"])
        for src in ("develop_grad.cu", "develop_grad_generic.cu"):
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
        objs = [os.path.join(OUT, f"{v['name']}.{s}.o")
                for s in ("develop_grad.cu", "develop_grad_generic.cu")]
        so = os.path.join(OUT, f"{v['name']}.so")
        subprocess.run([nvcc, *flags, "-shared", *objs, "-o", so], check=True)
        v["so"] = so


def ptxas_summary(text):
    """Lines 'registers/smem/spill' for the srgb instantiations."""
    lines = text.splitlines()
    res = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "Li2E" in ln:
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


def declare(lib):
    """The two grad launchers' C signatures (``ops/_build.load``)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rtt_develop_grad_launch.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.rtt_develop_grad_launch.restype = i32
    lib.rtt_develop_grad_cfa_launch.argtypes = ([ptr] * 4 + [i32] * 5
                                                + [ctypes.c_char_p, ptr])
    lib.rtt_develop_grad_cfa_launch.restype = i32
    return lib


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


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    metavar="NAME=DIR[,-DX=1...]")
    ap.add_argument("--sass", action="append", default=[], metavar="NAME")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tag", default="run", help="names the JSON record")
    ap.add_argument("--out", default=OUT,
                    help="directory of the record and the SASS listings")
    args = ap.parse_args(argv)
    variants = []
    for spec in args.variant:
        name, _, rest = spec.partition("=")
        where, *defs = rest.split(",")
        variants.append({"name": name, "dir": where, "defs": defs})
    return args, variants


def main(argv=None):
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    args, variants = parse_args(argv)
    sass_names = set(args.sass)
    from raweditor_tpu_torch import EditParams
    from raweditor_tpu_torch.color import cam_to_srgb_matrix
    from raweditor_tpu_torch.ops import fused_develop as fused
    from raweditor_tpu_torch.parallel.batch import pack_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("card:", smi, flush=True)
    t0 = time.perf_counter()
    build_all(variants)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(args.out, exist_ok=True)
    for v in variants:
        print(f"== ptxas {v['name']} (srgb instantiations)")
        for src, txt in v["ptxas"].items():
            print(f"  {src}:")
            print(ptxas_summary(txt))
        if v["name"] in sass_names:
            counts = sass_counts(v["so"], os.path.join(
                args.out, f"sass_{v['name']}.txt"))
            for fn, c in counts.items():
                if "Li2ELb0" in fn:
                    print(f"  SASS {v['name']} {fn}: "
                          f"{json.dumps(dict(sorted(c.items())))}")
        sys.stdout.flush()
    for v in variants:
        v["lib"] = declare(ctypes.CDLL(v["so"]))

    D3300 = np.array([[6988, -1384, -714], [-5631, 13410, 2447],
                      [-1485, 2204, 7318]], np.float32) / 10000.0
    rng = np.random.default_rng(20261016)
    batch_np = rng.integers(0, 4096, size=(4, H, W), dtype=np.uint16)
    batch = torch.from_numpy(batch_np).cuda()
    edit = EditParams(exposure=0.4, contrast=6.0, highlights=-0.3,
                      shadows=0.25, whites=1.05, blacks=0.03,
                      saturation=20.0, vibrance=0.4, temperature=0.1,
                      tint=-0.05)
    params = [edit, EditParams(), EditParams(exposure=-1.2, saturation=-40.0),
              EditParams(exposure=1.1, contrast=-5.0, vibrance=-0.5,
                         temperature=-0.3)]
    wb = np.array([[2.0, 1.0, 1.5], [1.8, 1.0, 1.4], [2.2, 1.0, 1.3],
                   [1.0, 1.0, 1.0]], np.float32)
    cm = np.tile(cam_to_srgb_matrix(D3300, "accurate"), (4, 1, 1))
    scal4 = pack_params(params, wb, cm, matrix_transpose=False,
                        white_levels=[4095.0, 4095.0, 4000.0, 16383.0],
                        black_levels=[150.0, 150.0, 64.0, 512.0]).cuda()
    one = batch[:1].contiguous()
    scal1 = scal4[:1].contiguous()
    xt_batch = batch[:, :XH, :XW].contiguous()
    xt_one = xt_batch[:1].contiguous()
    packed = fused.cfa_tables(fused.cfa_generic.XTRANS_PATTERN).packed
    stream = torch.cuda.current_stream().cuda_stream

    cases = {
        "B4_rgba": (one, scal1, 0, False), "B4_planes": (batch, scal4, 1, False),
        "B7_rgba": (xt_one, scal1, 0, True), "B7_planes": (xt_batch, scal4, 1, True),
    }

    def runner(v, mos, sc, output, cfa):
        n, h, w = mos.shape
        if output == 0:
            out0 = torch.empty((n, h, w), dtype=torch.uint32, device="cuda")
            out1 = None
        else:
            out0 = torch.empty((n, h, w), dtype=torch.uint8, device="cuda")
            out1 = torch.empty((n, h // 2, w), dtype=torch.uint8, device="cuda")
        p1 = None if out1 is None else out1.data_ptr()
        lib = v["lib"]

        def go():
            if cfa:
                code = lib.rtt_develop_grad_cfa_launch(
                    mos.data_ptr(), sc.data_ptr(), out0.data_ptr(), p1, n, h,
                    w, 2, output, packed, stream)
            else:
                code = lib.rtt_develop_grad_launch(
                    mos.data_ptr(), sc.data_ptr(), out0.data_ptr(), p1, n, h,
                    w, 0, 0, 2, output, stream)
            if code:
                raise RuntimeError(f"{v['name']}: CUDA error {code}")
        return go, (out0, out1)

    rounds, reps = args.rounds, args.reps
    table = {}
    for cname, (mos, sc, output, cfa) in cases.items():
        runs = {v["name"]: runner(v, mos, sc, output, cfa) for v in variants}
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
