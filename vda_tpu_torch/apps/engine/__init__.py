from vda_tpu_torch.apps.engine.engine import VideoDepthEngine  # noqa: F401
