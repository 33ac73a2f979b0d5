"""raw of raweditor_tpu_torch."""
