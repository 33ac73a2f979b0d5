"""utils of raweditor_tpu_torch."""
