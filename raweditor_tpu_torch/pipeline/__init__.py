"""pipeline of raweditor_tpu_torch."""
