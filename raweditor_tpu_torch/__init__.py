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

Ported so far: the parity develop of a decoded Bayer frame through
``DevelopEngine`` (slider tick preview and histogram, full-resolution
develop, JPEG export) and the fused develop kernel
(``ops/fused_develop.py``, ``csrc/develop.cu``) with RGBA and YCbCr
4:2:0 output.
"""

from raweditor_tpu_torch.color import cam_to_srgb_matrix
from raweditor_tpu_torch.ops.develop import (
    develop,
    develop_histogram,
    develop_preview,
    develop_rgba,
    develop_u8,
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
from raweditor_tpu_torch.raw.types import RawImage
from raweditor_tpu_torch.utils.device import resolve_device

__all__ = [
    "DevelopEngine",
    "EditParams",
    "LAUNCHES",
    "RawImage",
    "cam_to_srgb_matrix",
    "develop",
    "develop_histogram",
    "develop_preview",
    "develop_rgba",
    "develop_rgba_folded_plain",
    "develop_u8",
    "fold_scalars",
    "fused_batch_develop_rgba",
    "fused_develop_rgba",
    "histogram_256",
    "resolve_device",
    "rgba_view",
]
