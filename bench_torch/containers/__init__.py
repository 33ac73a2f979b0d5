"""The file writers, one module a container, that a configuration names
by its ``container`` key (``core.container_of``).

A container module gives:

- ``NAME``: the file-name pattern, formatted with the file's index from 1;
- ``base(rng, h, w, cfg)``: the seeded image every file is rolled from;
- ``write(path, image, cfg, device)``: one file of the image, through the
  frozen copy of the port's writer for that container;
- ``frame(image, cfg)``: what the program's decoder must read back from
  that file, in the form the configuration's reference module takes.

The drivers read two attributes of a frame themselves; the rest is the
reference's:

- ``mosaic``: the image as written, (H, W) CFA samples or (H, W, C)
  samples a pixel. ``catalog_export`` counts H x W pixels for the
  roofline readers; ``slider_session`` uploads it for the reference's
  ``preview`` and ``histogram``;
- ``pattern``: the CFA's X-Trans pattern (its 36 letters), or None for
  any other frame, from which ``catalog_export`` names the demosaic the
  roofline readers bound."""
