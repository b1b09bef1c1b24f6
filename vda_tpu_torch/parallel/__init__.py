"""Training and the multi-GPU layer of the port (``vda_tpu/parallel``
counterpart): ``mesh.py`` (the ('data', 'model') grid, partition rules
and collectives on torch.distributed), ``train.py``, ``trainer.py``."""
