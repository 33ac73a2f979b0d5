"""Headless command-line interface: ``python -m raweditor_tpu_torch <cmd>``.

The JAX package's CLI, with its 22 subcommands and their flags (the
argparse tree ``cli/_parser.py`` is a copy), over the port:

  import   recursive folder import + tier-cache generation
  list     catalog listing
  info     decode metadata for one file
  convert  rewrite RAW files as archival DNG (bit-exact sensor data)
  develop  one-shot develop of a file or catalog id to JPEG/PNG
  edit     save/reset slider values for a catalog image
  export   batch export with stored edits
  tiers    work the pending cache queue
  histogram  print the 256-bin histogram
  synth    write a synthetic RAW (test/bench fixture)
  rate     star ratings / pick-reject flags
  sidecar  XMP sidecar interchange
  verify   catalog integrity check
  validate real-file decoder validation
  auto     auto exposure/WB (+ levels/contrast/tone) suggestions
  collect  named collections: add/remove/delete/list
  preset   named develop presets
  session  interactive develop loop on stdin
  serve    TCP develop service speaking the session protocol
  warmup   build the CUDA kernels and launch each once
  doctor   environment self-check (one JSON report)
  bench    the benchmark

``--fast`` selects the fused CUDA kernels (``use_kernel``). The port adds
one flag of its own to the copied parser: ``export --trace-out PATH``
writes the export's spans as a Chrome trace. Entry points
run on the card unless ``RAWEDITOR_TPU_PLATFORM=cpu`` pins the CPU
(``utils/device.default_device``). What the port does not have yet
(presets, local adjustments, wide gamut, resize and geometry, 16-bit
TIFF, the multi-device export, the bench) exits with
``<cmd>: not ported yet: ...`` instead of a traceback.
"""

from __future__ import annotations

import sys

from raweditor_tpu_torch.cli._parser import build_parser
from raweditor_tpu_torch.cli._shared import (
    _add_lens_args,
    _add_slider_args,
    _apply_env_config_defaults,
    _clamp_zoom,
    _finite_pan,
    _finite_rotate,
    _open_engine,
    _open_library,
    _params_from_args,
    _parse_crop,
    _parse_lens,
    _parse_local_spec,
)
from raweditor_tpu_torch.cli.catalog import (
    _apply_sidecars,
    cmd_collect,
    cmd_edit,
    cmd_import,
    cmd_list,
    cmd_preset,
    cmd_rate,
    cmd_sidecar,
    cmd_tiers,
    cmd_verify,
)
from raweditor_tpu_torch.cli.develop_cmds import (
    _resolve_input,
    cmd_auto,
    cmd_convert,
    cmd_develop,
    cmd_histogram,
    cmd_info,
    cmd_synth,
    render_ascii_histogram,
)
from raweditor_tpu_torch.cli.diag import cmd_bench, cmd_doctor, cmd_validate
from raweditor_tpu_torch.cli.export_cmds import (
    _run_batch_export_checked,
    cmd_export,
    cmd_warmup,
)
from raweditor_tpu_torch.cli.service import cmd_serve, cmd_session

_COMMANDS = {
    "import": cmd_import,
    "list": cmd_list,
    "info": cmd_info,
    "convert": cmd_convert,
    "rate": cmd_rate,
    "sidecar": cmd_sidecar,
    "collect": cmd_collect,
    "develop": cmd_develop,
    "edit": cmd_edit,
    "preset": cmd_preset,
    "export": cmd_export,
    "tiers": cmd_tiers,
    "verify": cmd_verify,
    "validate": cmd_validate,
    "histogram": cmd_histogram,
    "serve": cmd_serve,
    "synth": cmd_synth,
    "auto": cmd_auto,
    "session": cmd_session,
    "bench": cmd_bench,
    "warmup": cmd_warmup,
    "doctor": cmd_doctor,
}


def _missing_port_module(e: ImportError):
    """The name of the module of this package that ``e`` failed to find
    (``import raweditor_tpu_torch.x`` or ``from raweditor_tpu_torch
    import x``), or None when ``e`` is about anything else: an import
    that fails inside a module that exists is a fault, not a module
    still to port."""
    import importlib.util

    name = e.name or ""
    if name.split(".")[0] != "raweditor_tpu_torch":
        return None
    if getattr(e, "name_from", None):
        # ``from package import x``: x is missing as a submodule only if
        # ``package`` is a package; a module lacks an attribute.
        spec = importlib.util.find_spec(name)
        if spec is None or spec.submodule_search_locations is None:
            return None
        name = f"{name}.{e.name_from}"
    try:
        if importlib.util.find_spec(name) is not None:
            return None
    except ImportError:  # a parent package is missing too
        pass
    return name


def _port_parser():
    """The JAX CLI's parser (``_parser.py``, a copy) with the port's own
    flags: ``export --trace-out PATH``."""
    import argparse

    parser = build_parser()
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    sub.choices["export"].add_argument(
        "--trace-out", metavar="PATH", default=None,
        help="write the export's spans as a Chrome trace JSON (threads "
             "as tid, each span's image id and flush number in args; "
             "times on torch.profiler's clock)")
    return parser


def main(argv=None) -> int:
    # The device is touched lazily where an engine or the exporter is
    # built: catalog-only commands never need the card.
    args = _port_parser().parse_args(argv)
    _apply_env_config_defaults(args)
    if getattr(args, "xlat", None):
        from raweditor_tpu_torch.raw import nikon_crypt

        try:
            nikon_crypt.inject_xlat_file(args.xlat)
        except (OSError, ValueError) as e:
            raise SystemExit(f"--xlat: {e}")
    try:
        return _COMMANDS[args.cmd](args)
    except NotImplementedError as e:
        raise SystemExit(f"{args.cmd}: {e}")
    except ImportError as e:
        missing = _missing_port_module(e)
        if missing is None:
            raise
        raise SystemExit(f"{args.cmd}: not ported yet: {missing}")
    except BrokenPipeError:
        # `raweditor-tpu list | head`: the consumer closed the pipe.
        # Exit quietly like standard unix tools (128 + SIGPIPE),
        # pointing stdout at devnull so interpreter teardown doesn't
        # traceback on the final flush.
        import os as _os

        devnull = _os.open(_os.devnull, _os.O_WRONLY)
        _os.dup2(devnull, sys.stdout.fileno())
        return 141


if __name__ == "__main__":
    sys.exit(main())
