"""ops of raweditor_tpu_torch."""
