"""parallel of raweditor_tpu_torch."""
