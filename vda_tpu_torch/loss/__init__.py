"""Training loss of the port (``vda_tpu/loss`` counterpart)."""

from vda_tpu_torch.loss.loss import video_depth_loss  # noqa: F401
