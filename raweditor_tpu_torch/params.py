"""Non-destructive edit parameters, as a plain frozen dataclass.

Field for field the JAX package's ``EditParams``: the reference's ten
sliders first, then the finish extras, the HSL mixer, colour grading and
highlight recovery, with the same names, order and defaults. ``to_json``
emits the same bytes as the JAX class (the reference's ten fields always,
the rest only when non-default), so catalog rows carry over unchanged.

No pytree registration: the port's develop functions read the values as
Python floats and build their own f32 scalars on the target device.
``point_curve`` round-trips through JSON as the JAX class does (checked
by ``ops/curve.validate_points``). Local-adjustment masks are not ported
yet: the field exists (empty by default), and a JSON payload or
``to_json`` that carries masks raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from raweditor_tpu_torch.ops.curve import validate_points

_REF_FIELDS = (
    "exposure", "contrast", "highlights", "shadows", "whites", "blacks",
    "vibrance", "saturation", "temperature", "tint",
)
_MIXER_BANDS = ("red", "orange", "yellow", "green", "aqua", "blue",
                "purple", "magenta")
MIXER_FIELDS = tuple(f"{ctl}_{band}" for ctl in ("hue", "sat", "lum")
                     for band in _MIXER_BANDS)
GRADE_FIELDS = ("grade_shadow_hue", "grade_shadow_sat",
                "grade_mid_hue", "grade_mid_sat",
                "grade_high_hue", "grade_high_sat",
                "grade_balance")
_EXTRA_FIELDS = (
    ("sharpen", "denoise", "curve_shadows", "curve_darks", "curve_lights",
     "curve_highlights", "vignette", "clarity", "dehaze", "grain",
     "grain_size")
    + MIXER_FIELDS + GRADE_FIELDS + ("highlight_recovery",)
)
# The stencil extras of the finish post-pass (clarity and the mixer are
# gated separately, see finish_extras_mode).
_STENCIL_FIELDS = ("sharpen", "denoise", "curve_shadows", "curve_darks",
                   "curve_lights", "curve_highlights", "vignette")
# highlight_recovery rewrites the mosaic before demosaic; it is not a
# finish extra.
_FINISH_FIELDS = tuple(f for f in _EXTRA_FIELDS
                       if f != "highlight_recovery")
_FIELDS = _REF_FIELDS + _EXTRA_FIELDS

_DEFAULTS = {name: 0.0 for name in _FIELDS}
_DEFAULTS["whites"] = 1.0


@dataclasses.dataclass(frozen=True)
class EditParams:
    """All edit parameters for one image."""

    exposure: float = 0.0
    contrast: float = 0.0
    highlights: float = 0.0
    shadows: float = 0.0
    whites: float = 1.0
    blacks: float = 0.0
    vibrance: float = 0.0
    saturation: float = 0.0
    temperature: float = 0.0
    tint: float = 0.0
    sharpen: float = 0.0
    denoise: float = 0.0
    curve_shadows: float = 0.0
    curve_darks: float = 0.0
    curve_lights: float = 0.0
    curve_highlights: float = 0.0
    vignette: float = 0.0
    clarity: float = 0.0
    dehaze: float = 0.0
    grain: float = 0.0
    grain_size: float = 0.0
    hue_red: float = 0.0
    hue_orange: float = 0.0
    hue_yellow: float = 0.0
    hue_green: float = 0.0
    hue_aqua: float = 0.0
    hue_blue: float = 0.0
    hue_purple: float = 0.0
    hue_magenta: float = 0.0
    sat_red: float = 0.0
    sat_orange: float = 0.0
    sat_yellow: float = 0.0
    sat_green: float = 0.0
    sat_aqua: float = 0.0
    sat_blue: float = 0.0
    sat_purple: float = 0.0
    sat_magenta: float = 0.0
    lum_red: float = 0.0
    lum_orange: float = 0.0
    lum_yellow: float = 0.0
    lum_green: float = 0.0
    lum_aqua: float = 0.0
    lum_blue: float = 0.0
    lum_purple: float = 0.0
    lum_magenta: float = 0.0
    grade_shadow_hue: float = 0.0
    grade_shadow_sat: float = 0.0
    grade_mid_hue: float = 0.0
    grade_mid_sat: float = 0.0
    grade_high_hue: float = 0.0
    grade_high_sat: float = 0.0
    grade_balance: float = 0.0
    highlight_recovery: float = 0.0
    # Structural fields of the JAX class: local-adjustment masks (not
    # ported yet) and the point curve's (x, y) control points.
    locals: Any = ()
    point_curve: Any = ()

    # -- persistence -----------------------------------------------------
    def to_json(self) -> str:
        """The JAX class's JSON: the ten reference fields always, the
        extras only when non-default, then the point curve when set."""
        if self.locals:
            raise NotImplementedError("not ported yet: local adjustments")
        data = {name: float(getattr(self, name)) for name in _REF_FIELDS}
        for name in _EXTRA_FIELDS:
            v = float(getattr(self, name))
            if v != _DEFAULTS[name]:
                data[name] = v
        if self.point_curve:
            data["point_curve"] = [
                [float(x), float(y)] for x, y in self.point_curve]
        return json.dumps(data)

    @classmethod
    def from_json(cls, payload: str) -> "EditParams":
        """Parse a catalog JSON blob: unknown keys raise, missing keys
        take their defaults, a point curve is validated."""
        data = json.loads(payload)
        if "locals" in data:
            raw = data.pop("locals")
            if not isinstance(raw, list):
                raise ValueError("'locals' must be a list of masks")
            if raw:
                raise NotImplementedError("not ported yet: local adjustments")
        curve = ()
        if "point_curve" in data:
            raw = data.pop("point_curve")
            if not isinstance(raw, list):
                raise ValueError(
                    "'point_curve' must be a list of [x, y] pairs")
            curve = validate_points(raw)
        return cls.from_dict(data).replace(point_curve=curve)

    @classmethod
    def from_dict(cls, d) -> "EditParams":
        """Build from ``{field: float}`` (the JAX ``EditParams`` as a
        mapping of its slider fields)."""
        unknown = set(d) - set(_FIELDS)
        if unknown:
            raise ValueError(f"unknown edit parameter(s): {sorted(unknown)}")
        merged = dict(_DEFAULTS)
        merged.update({k: float(v) for k, v in d.items()})
        return cls(**merged)

    # -- convenience -----------------------------------------------------
    def has_finish_extras(self) -> bool:
        """True when any finish extra is active."""
        return any(float(getattr(self, name)) != _DEFAULTS[name]
                   for name in _FINISH_FIELDS)

    def has_mixer(self) -> bool:
        return any(float(getattr(self, name)) != 0.0 for name in MIXER_FIELDS)

    def mixer_values(self) -> tuple:
        """The 24 mixer sliders in MIXER_FIELDS order (hue x8, sat x8,
        lum x8): the positional contract of ``ops.mixer.apply_hsl_mixer``."""
        return tuple(getattr(self, name) for name in MIXER_FIELDS)

    def has_grading(self) -> bool:
        return any(float(getattr(self, name)) != 0.0
                   for name in ("grade_shadow_sat", "grade_mid_sat",
                                "grade_high_sat"))

    def grading_values(self) -> tuple:
        """The 7 grading sliders in GRADE_FIELDS order: the positional
        contract of ``ops.grading.apply_color_grading``."""
        return tuple(getattr(self, name) for name in GRADE_FIELDS)

    def finish_extras_mode(self):
        """False, or the "+"-joined parts ("base"/"full", "mixer",
        "grading", "grain") the JAX develop entry points specialise on."""
        if not self.has_finish_extras():
            return False
        stencils = any(float(getattr(self, name)) != _DEFAULTS[name]
                       for name in _STENCIL_FIELDS)
        clar = float(self.clarity) != 0.0 or float(self.dehaze) != 0.0
        parts = []
        if stencils or clar:
            parts.append("full" if clar else "base")
        if self.has_mixer():
            parts.append("mixer")
        if self.has_grading():
            parts.append("grading")
        if float(self.grain) != 0.0:
            parts.append("grain")
        return "+".join(parts) if parts else False

    def replace(self, **kwargs: Any) -> "EditParams":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def field_names(cls) -> tuple:
        return _FIELDS
