"""Batch export + warmup subcommands.

The JAX CLI's module with these changes: ``--fast`` maps to the
exporter's ``use_kernel`` (the fused CUDA kernels); ``--num-hosts`` above
1 and ``--mesh-rows`` raise "not ported yet" (the multi-device export);
``--trace-out PATH`` writes the call's spans as a Chrome trace (the
report line carries their totals under ``stages`` either way);
``warmup`` builds the CUDA kernel library and launches each develop
kernel and the finish-extras kernel once at the given shape."""

from __future__ import annotations

import json

import numpy as np

from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.cli._shared import (
    _finite_rotate,
    _open_library,
    _params_from_args,
    _parse_crop,
    _parse_lens,
    _parse_perspective,
)


def cmd_export(args) -> int:
    # FIRST: the opt-in arena respawn must run before thread pools or
    # the CUDA context exist (exec replaces the process; glibc reads
    # MALLOC_ARENA_MAX only at startup). No-op unless --arena-respawn
    # or RAWEDITOR_TPU_ARENA_RESPAWN=1.
    from raweditor_tpu_torch.utils.memory import maybe_respawn_for_arena_cap

    maybe_respawn_for_arena_cap(
        enabled=getattr(args, "arena_respawn", False))

    from raweditor_tpu_torch.pipeline.export import (
        ExportJob,
        jobs_from_catalog,
        run_batch_export,
    )
    from raweditor_tpu_torch.utils.config import Config

    num_hosts = getattr(args, "num_hosts", 1)
    host_id = getattr(args, "host_id", 0)
    if num_hosts < 1:
        raise SystemExit(f"--num-hosts must be >= 1 (got {num_hosts})")
    if not 0 <= host_id < num_hosts:
        raise SystemExit(
            f"--host-id {host_id} out of range for --num-hosts {num_hosts}")
    if num_hosts > 1:
        raise NotImplementedError("not ported yet: --num-hosts "
                                  "(multi-host export)")
    if args.mesh_rows:
        raise NotImplementedError("not ported yet: --mesh-rows (rows "
                                  "sharded over devices)")

    cfg = Config.from_env()
    override = _params_from_args(args)
    if args.files is not None:
        # `is not None`: an EMPTY --files (a glob that matched
        # nothing) must not silently fall through to a full-catalog
        # export (code-review r3).
        if not args.files:
            raise SystemExit("export: --files matched no files")
        import os

        jobs = []
        taken = set()
        for f in args.files:
            stem = os.path.splitext(os.path.basename(f))[0]
            # Same stem-collision guard as jobs_from_catalog: two
            # IMG_0001.NEF from different folders must not clobber
            # each other (code-review r3).
            name = f"{stem}.{args.ext}"
            if name.lower() in taken:
                i = 2
                while f"{stem}_{i}.{args.ext}".lower() in taken:
                    i += 1
                name = f"{stem}_{i}.{args.ext}"
            taken.add(name.lower())
            jobs.append(ExportJob(
                raw_path=f,
                out_path=os.path.join(args.out_dir, name),
                params=override,
            ))
    else:
        with _open_library(args) as lib:
            ids = args.ids
            min_rating = getattr(args, "min_rating", 0) or 0
            flag = getattr(args, "flag", None)
            collection = getattr(args, "collection", None)
            if min_rating or flag or collection:
                picked = {i.id for i in lib.filter_images(
                    min_rating=min_rating, flag=flag,
                    collection=collection)}
                ids = sorted(picked if ids is None
                             else picked & set(ids))
            jobs = jobs_from_catalog(lib, args.out_dir, ids, args.ext)
        # CLI slider overrides apply ON TOP of each image's stored
        # edits (the export parser advertises every slider; they were
        # silently dropped for catalog exports — code-review r3).
        if (getattr(args, "preset", None)
                or getattr(args, "local", None)
                or getattr(args, "curve", None) is not None
                or any(getattr(args, n, None) is not None
                       for n in EditParams.field_names())):
            import dataclasses as _dc

            jobs = [_dc.replace(j, params=_params_from_args(
                args, j.params)) for j in jobs]

    auto_extras = [n for n in ("auto_levels", "auto_contrast",
                               "auto_tone") if getattr(args, n, False)]
    if auto_extras and not getattr(args, "auto", False):
        raise SystemExit(
            f"--{auto_extras[0].replace('_', '-')} refines the --auto "
            "pass and needs it; pass --auto as well")
    if getattr(args, "auto", False):
        # Per-image auto adjustments measured on device at preview
        # resolution, applied on top of each job's params (stored edits
        # or CLI overrides — same composition as the `auto`
        # subcommand). This is a separate measurement pass, so each
        # image is decoded once extra; the per-image decodes are
        # independent, so they run on the same thread width as the
        # export proper. Decode errors are left for the export's
        # per-image quarantine to report; anything else is a real
        # problem (a device or suggest bug) and must be visible at
        # the default log level — the image still exports, un-adjusted.
        import dataclasses as _dc
        from concurrent.futures import ThreadPoolExecutor as _TPE

        from raweditor_tpu_torch.pipeline.auto import suggest_auto
        from raweditor_tpu_torch.pipeline.engine import DevelopEngine
        from raweditor_tpu_torch.raw.decode import RawDecodeError
        from raweditor_tpu_torch.utils.logging import get_logger

        _log = get_logger("raweditor_tpu_torch.cli")

        if getattr(args, "resume", False):
            # skip_existing drops these jobs inside run_batch_export
            # anyway — don't pay a decode + device measurement pass
            # per already-exported image (code-review r3).
            import os as _os

            jobs = [j for j in jobs if not _os.path.exists(j.out_path)]

        def _measure(j):
            try:
                eng = DevelopEngine.open(j.raw_path)
                return _dc.replace(j, params=suggest_auto(
                    eng, j.params,
                    include_levels="auto_levels" in auto_extras,
                    include_contrast="auto_contrast" in auto_extras,
                    include_tone="auto_tone" in auto_extras,
                ))
            except (OSError, RawDecodeError) as e:
                _log.info("auto pass skipped for %s (%s: %s)",
                          j.raw_path, type(e).__name__, str(e)[:120])
            except Exception as e:
                _log.warning(
                    "auto pass failed for %s — exporting without auto "
                    "adjustments (%s: %s)",
                    j.raw_path, type(e).__name__, str(e)[:120])
            return j

        with _TPE(max_workers=max(1, args.decode_threads)) as pool:
            jobs = list(pool.map(_measure, jobs))
    try:
        report = _run_batch_export_checked(run_batch_export, jobs, args,
                                           cfg)
    except ValueError as e:
        raise SystemExit(f"export: {e}")
    trace_out = getattr(args, "trace_out", None)
    if trace_out:
        with open(trace_out, "w") as f:
            json.dump(report.timer.chrome_trace(), f)
    print(json.dumps(report.as_dict()))
    return 0 if not report.failed else 1


def _run_batch_export_checked(run_batch_export, jobs, args, cfg):
    """The export invocation, separated so config ValueErrors surface
    as usage errors (code-review r3)."""
    return run_batch_export(
        jobs, batch_size=args.batch_size,
        decode_threads=args.decode_threads,
        encode_threads=cfg.encode_threads, quality=args.quality,
        mode=args.mode, skip_existing=args.resume,
        fast_gamma=getattr(args, "fast_gamma", False),
        demosaic_method=getattr(args, "demosaic", "nearest"),
        use_kernel=getattr(args, "fast", False),
        transfer=(args.transfer if getattr(args, "transfer", "gamma22")
                  != "gamma22" else None),
        bits=16 if args.ext == "tif" else 8,
        long_edge=getattr(args, "long_edge", 0) or None,
        jpeg_optimize=(getattr(args, "optimize_jpeg", False)
                       or cfg.jpeg_optimize),
        chroma=getattr(args, "chroma", "420"),
        jpeg_restart_rows=getattr(args, "jpeg_restart", 0),
        color_space=getattr(args, "color_space", "srgb"),
        rotate=_finite_rotate(args),
        crop=_parse_crop(getattr(args, "crop", None)),
        lens=_parse_lens(args),
        perspective=_parse_perspective(args),
        on_progress=(_progress_printer()
                     if getattr(args, "progress", False) else None),
        trace_spans=bool(getattr(args, "trace_out", None)),
    )


def _progress_printer():
    """--progress: one JSON line per update on stderr (stdout stays
    the single report line) with done/failed/total, rate, and an ETA
    from the completed-image rate."""
    import sys
    import time as _time

    def emit(done, failed, total, seconds):
        rate = done / seconds if seconds > 0 else 0.0
        left = total - done - failed
        eta = left / rate if rate > 0 else None
        print(json.dumps({
            "progress": True, "done": done, "failed": failed,
            "total": total, "seconds": round(seconds, 1),
            "images_per_sec": round(rate, 3),
            "eta_seconds": round(eta, 1) if eta is not None else None,
            "ts": _time.strftime("%H:%M:%S"),
        }), file=sys.stderr, flush=True)

    return emit


def cmd_warmup(args) -> int:
    """Build the CUDA kernel library from the sources and launch each
    develop kernel (every Bayer demosaic, every X-Trans tier) and the
    finish-extras kernel once at ``--height`` x ``--width`` on a batch of
    ``--batch-size`` frames (one by default), so a service's first
    request pays neither the build nor the first launch (which derives
    the quantiser tables). With the CPU pinned the wrappers run the
    kernels' plain versions and nothing is built. ``--fast`` changes
    nothing: every kernel is built."""
    import time

    import torch

    from raweditor_tpu_torch.ops import cfa_generic
    from raweditor_tpu_torch.ops import fused_develop as fused
    from raweditor_tpu_torch.ops import fused_extras as fx
    from raweditor_tpu_torch.utils.device import resolve_device

    device = resolve_device(None)
    n, h, w = max(1, args.batch_size), args.height, args.width
    compiled = []

    def step(name, fn):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        compiled.append({"program": name,
                         "seconds": round(time.perf_counter() - t0, 2)})

    if device.type == "cuda":
        from raweditor_tpu_torch.ops import _build

        step("build", lambda: (_build.build(), _build.load()))
    rng = np.random.default_rng(0)
    mosaics = torch.from_numpy(rng.integers(
        0, 4096, size=(n, h, w), dtype=np.uint16)).to(device)
    params = EditParams(exposure=0.1, sharpen=40.0, hue_red=10.0,
                        grade_mid_sat=20.0)
    scal = fused.fold_scalars(
        params, np.array([2.0, 1.0, 1.4], np.float32),
        np.eye(3, dtype=np.float32)).to(device).expand(n, -1).contiguous()
    for pattern, tiers in ((None, fused.DEMOSAICS),
                           (cfa_generic.XTRANS_PATTERN,
                            fused.CFA_DEMOSAICS)):
        for m in tiers:
            key = fused.launch_key("rgba", m, pattern)
            step(key, lambda m=m, pattern=pattern:
                 fused.fused_batch_develop_rgba(mosaics, scal, demosaic=m,
                                                pattern=pattern))
    words = fused.fused_batch_develop_rgba(mosaics, scal)
    table, *flags = fx.pack_extras([params] * n)
    step("extras_rgba", lambda: fx.fused_finish_extras_rgba(
        words, table.to(device),
        **dict(zip(("mixer_on", "grading_on", "stencils"), flags))))
    print(json.dumps({"width": w, "height": h, "device": str(device),
                      "compiled": compiled}))
    return 0
