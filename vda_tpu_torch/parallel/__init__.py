"""Training of the port on one device (``vda_tpu/parallel`` counterpart)."""
