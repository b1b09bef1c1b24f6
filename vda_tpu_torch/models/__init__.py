"""Models of the port: DINOv2 encoder, temporal DPT head, full model."""
