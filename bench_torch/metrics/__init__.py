"""The per-layer readers, one file per metric: ``<name>.py`` with
``read(record)``, found by name."""
