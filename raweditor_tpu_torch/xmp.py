"""XMP sidecar interchange for edits and ratings.

Capability beyond the reference editor (whose edits live only in its
SQLite catalog, reference: state/library.rs:310-341): standard
``.xmp`` sidecar files next to the RAW, the interchange convention
every desktop RAW workflow understands. Two payloads live in one
packet:

- **Portable fields.** ``xmp:Rating`` (0–5 stars; −1 = rejected, the
  widespread Adobe/Bridge convention for the reject flag) and
  ``xmp:Label`` — these round-trip with third-party tools (Lightroom,
  Bridge, digiKam all read/write ``xmp:Rating``).
- **Full edit state**, under this project's own namespace
  ``rwt = https://raweditor-tpu.dev/ns/1.0/``: the exact
  ``EditParams`` serde JSON (params.EditParams.to_json — the same
  blob the catalog stores, locals included) in an
  ``<rwt:EditParams>`` element, plus the ten reference sliders
  duplicated as individual readable attributes for humans and
  scripts. We deliberately do NOT write Adobe ``crs:`` develop
  values: the slider spaces differ (e.g. crs temperature is Kelvin,
  ours is the reference's −1…1 mix; crs tone sliders assume Adobe's
  process version), so any mapping would silently misrepresent the
  edit. Honest interchange = our namespace exactly + the universal
  rating/label fields.

Sidecar naming follows the Adobe convention — ``IMG_0001.NEF`` ↔
``IMG_0001.xmp`` — and :func:`find_sidecar` also accepts the
extension-appending form ``IMG_0001.NEF.xmp`` (darktable's default)
on read.

Parsing is strict the same way params.EditParams.from_json is:
unknown ``rwt:`` fields raise ``ValueError`` (a sidecar from a newer
version must not be silently half-applied); missing fields default.
Malformed XML raises ``ValueError`` too — sidecars are user-managed
files, not RAW payloads, so this is a plain input error, not a
``RawDecodeError`` (the batch quarantine contract stays decode-only).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Optional, Tuple

from raweditor_tpu_torch.params import EditParams, _REF_FIELDS

#: This project's XMP namespace (full edit state, exact round trip).
RWT_NS = "https://raweditor-tpu.dev/ns/1.0/"
#: Standard namespaces used in the packet.
XMP_NS = "http://ns.adobe.com/xap/1.0/"
RDF_NS = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
X_NS = "adobe:ns:meta/"

_XPACKET_BEGIN = "<?xpacket begin=\"﻿\" id=\"W5M0MpCehiHzreSzNTczkc9d\"?>\n"
_XPACKET_END = "\n<?xpacket end=\"w\"?>\n"


def params_to_xmp(params: EditParams, rating: Optional[int] = None,
                  flag: str = "none", label: Optional[str] = None) -> str:
    """Serialize edits (+ optional rating/flag/label) to an XMP packet
    string. ``rating`` is 0–5 stars; ``flag == "reject"`` writes the
    conventional ``xmp:Rating="-1"`` regardless of stars (that is how
    rejects survive a trip through Adobe tools); ``flag == "pick"``
    has no portable XMP form and is carried as ``rwt:Flag``."""
    ET.register_namespace("x", X_NS)
    ET.register_namespace("rdf", RDF_NS)
    ET.register_namespace("xmp", XMP_NS)
    ET.register_namespace("rwt", RWT_NS)
    root = ET.Element(f"{{{X_NS}}}xmpmeta")
    rdf = ET.SubElement(root, f"{{{RDF_NS}}}RDF")
    desc = ET.SubElement(rdf, f"{{{RDF_NS}}}Description")
    desc.set(f"{{{RDF_NS}}}about", "")
    if flag == "reject":
        # Always write the portable reject marker, stars or not — a
        # read→write round trip (xmp_to_params returns rating=None for
        # rejects) must not drop the Adobe-visible Rating="-1".
        desc.set(f"{{{XMP_NS}}}Rating", "-1")
    elif rating is not None:
        desc.set(f"{{{XMP_NS}}}Rating", str(int(rating)))
    if label:
        desc.set(f"{{{XMP_NS}}}Label", str(label))
    if flag and flag != "none":
        desc.set(f"{{{RWT_NS}}}Flag", flag)
    # Human-readable duplicates of the ten reference sliders.
    blob = json.loads(params.to_json())
    for name in _REF_FIELDS:
        desc.set(f"{{{RWT_NS}}}{name}", repr(blob[name]))
    # The exact serde JSON — the authoritative payload on read.
    payload = ET.SubElement(desc, f"{{{RWT_NS}}}EditParams")
    payload.text = params.to_json()
    body = ET.tostring(root, encoding="unicode")
    return _XPACKET_BEGIN + body + _XPACKET_END


def xmp_to_params(text: str) -> Tuple[EditParams, Optional[int], str,
                                      Optional[str]]:
    """Parse an XMP packet → (params, rating, flag, label).

    ``rating`` is None when the packet carries no ``xmp:Rating``;
    ``flag`` is "none"/"pick"/"reject" (an ``xmp:Rating`` of −1 maps
    to "reject" with rating None, the inverse of the writer). A
    packet without any ``rwt:`` payload (e.g. written by a third
    party just to rate the file) yields default EditParams. Raises
    ``ValueError`` on malformed XML or unknown ``rwt:`` fields."""
    # Strip the xpacket PIs if present (ElementTree rejects leading PIs
    # only when they precede the XML declaration — just be tolerant).
    body = text.strip()
    if body.startswith("<?xpacket"):
        body = body[body.index("?>") + 2:]
    end = body.rfind("<?xpacket")
    if end != -1:
        body = body[:end]
    try:
        root = ET.fromstring(body.strip())
    except ET.ParseError as e:
        raise ValueError(f"malformed XMP sidecar: {e}") from None

    descs = root.findall(f".//{{{RDF_NS}}}Description")
    if not descs:
        raise ValueError("XMP packet has no rdf:Description")
    rating: Optional[int] = None
    flag = "none"
    label: Optional[str] = None
    params: Optional[EditParams] = None
    attrs = {}
    for desc in descs:
        rate = desc.get(f"{{{XMP_NS}}}Rating")
        if rate is not None:
            r = int(float(rate))
            if r < 0:
                flag, rating = "reject", None
            else:
                rating = max(0, min(5, r))
        lab = desc.get(f"{{{XMP_NS}}}Label")
        if lab is not None:
            label = lab
        fl = desc.get(f"{{{RWT_NS}}}Flag")
        if fl is not None:
            if fl not in ("none", "pick", "reject"):
                raise ValueError(f"unknown rwt:Flag {fl!r}")
            flag = fl
        payload = desc.find(f"{{{RWT_NS}}}EditParams")
        if payload is not None and payload.text:
            params = EditParams.from_json(payload.text)
        for key, val in desc.attrib.items():
            if key.startswith(f"{{{RWT_NS}}}"):
                name = key[len(RWT_NS) + 2:]
                if name == "Flag":
                    continue
                if name not in EditParams.field_names():
                    raise ValueError(
                        f"unknown rwt edit field {name!r} in sidecar")
                attrs[name] = float(val)
    if params is None:
        # Fall back to the per-field attributes (or defaults for a
        # rating-only third-party packet).
        params = EditParams(**attrs) if attrs else EditParams()
    return params, rating, flag, label


def sidecar_path_for(raw_path: os.PathLike) -> str:
    """The sidecar path this module WRITES: Adobe's basename
    convention (``IMG_0001.NEF`` → ``IMG_0001.xmp``)."""
    base, _ = os.path.splitext(str(raw_path))
    return base + ".xmp"


def find_sidecar(raw_path: os.PathLike) -> Optional[str]:
    """The sidecar to READ for ``raw_path``: the basename form first,
    then the extension-appending form (``IMG_0001.NEF.xmp``)."""
    base = sidecar_path_for(raw_path)
    if os.path.exists(base):
        return base
    appended = str(raw_path) + ".xmp"
    if os.path.exists(appended):
        return appended
    return None


def write_sidecar(raw_path: os.PathLike, params: EditParams,
                  rating: Optional[int] = None, flag: str = "none",
                  label: Optional[str] = None) -> str:
    """Write the sidecar next to ``raw_path`` (atomic: temp + rename,
    like every other writer in the package). Returns the path."""
    out = sidecar_path_for(raw_path)
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(params_to_xmp(params, rating=rating, flag=flag,
                               label=label))
    os.replace(tmp, out)
    return out


def read_sidecar(path: os.PathLike):
    """Read an ``.xmp`` file → (params, rating, flag, label)."""
    with open(path, "r", encoding="utf-8") as fh:
        return xmp_to_params(fh.read())
