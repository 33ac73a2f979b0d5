"""raweditor_tpu_torch: the RAW develop engine in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

A port of the JAX package ``raweditor_tpu``, which stays in the
repository as the reference: the tests run both on the same inputs and
compare. This package imports torch and numpy, never jax and never
``raweditor_tpu``, for two reasons: the machine with the card has no
jax, and importing any submodule of ``raweditor_tpu`` runs its
``__init__.py``, which imports jax. The one piece shared with the JAX
package is the compiled JFIF encoder ``_rawkit``, loaded by file path
(``native.py``).

Ported so far: the develop of a decoded Bayer, X-Trans or LinearRaw frame
through
``DevelopEngine`` (slider tick preview and histogram, full-resolution
develop, JPEG, PNG and 16-bit TIFF export with the device resize and
output geometry) in parity and accurate mode, with the nearest,
bilinear, Malvar-He-Cutler and gradient-weighted Bayer demosaics and the
nearest, smooth and gradient-weighted generic-CFA tiers
(``demosaic_method``), the finish extras, and the fused develop kernels
with RGBA and YCbCr 4:2:0 output (``ops/fused_develop.py``):
``csrc/develop.cu`` for the nearest, bilinear and Malvar stencils and the
generic-CFA nearest and smooth ones, ``csrc/develop_grad.cu`` and
``csrc/develop_grad_generic.cu`` for the gradient-weighted ones, and
``csrc/extras.cu`` for the finish extras. The engine hands
``demosaic_method`` to the kernels as their ``demosaic`` argument (and an
X-Trans frame's pattern as ``pattern``). The CPU tests run the kernels'
plain versions (a wrapper runs them for CPU tensors only); the kernels
themselves run on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

From a file on disk: ``decode_raw`` (``raw/decode.py`` and the per-maker
decoders under ``raw/``), ``DevelopEngine.open(path)`` on top of it, the
SQLite catalog ``Library`` (``catalog/``) and XMP sidecars (``xmp.py``).
These host-side modules, and the writers under ``raw/`` that make test
files, are copies of the JAX package's jax-free modules with the package
name rewritten (``tests/test_torch_source_guard.py`` holds each copy
equal to its source).
"""

from raweditor_tpu_torch.catalog import Library
from raweditor_tpu_torch.color import cam_to_output_matrix, cam_to_srgb_matrix
from raweditor_tpu_torch.ops.demosaic import (
    DEMOSAIC_METHODS,
    demosaic,
    demosaic_bilinear,
    demosaic_malvar,
)
from raweditor_tpu_torch.ops.develop import (
    develop,
    develop_histogram,
    develop_linear,
    develop_preview,
    develop_rgba,
    develop_u8,
    develop_u16,
    develop_xtrans,
    develop_xtrans_histogram,
    develop_xtrans_preview,
    histogram_256,
    rgba_view,
)
from raweditor_tpu_torch.ops.fused_develop import (
    LAUNCHES,
    develop_rgba_folded_plain,
    fold_scalars,
    fused_batch_develop_rgba,
    fused_develop_rgba,
)
from raweditor_tpu_torch.params import EditParams
from raweditor_tpu_torch.pipeline.engine import DevelopEngine
from raweditor_tpu_torch.raw.decode import RawDecodeError, decode_raw
from raweditor_tpu_torch.raw.types import RawImage
from raweditor_tpu_torch.utils.device import resolve_device

__all__ = [
    "DEMOSAIC_METHODS",
    "DevelopEngine",
    "EditParams",
    "LAUNCHES",
    "Library",
    "RawDecodeError",
    "RawImage",
    "cam_to_output_matrix",
    "cam_to_srgb_matrix",
    "decode_raw",
    "demosaic",
    "demosaic_bilinear",
    "demosaic_malvar",
    "develop",
    "develop_histogram",
    "develop_linear",
    "develop_preview",
    "develop_rgba",
    "develop_rgba_folded_plain",
    "develop_u8",
    "develop_u16",
    "develop_xtrans",
    "develop_xtrans_histogram",
    "develop_xtrans_preview",
    "fold_scalars",
    "fused_batch_develop_rgba",
    "fused_develop_rgba",
    "histogram_256",
    "resolve_device",
    "rgba_view",
]
