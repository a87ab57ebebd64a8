"""The multi-device layer on ``torch.distributed`` (the JAX package's
``parallel/``): the image rows are the data-parallel axis
(``sharding.py``: ``render_sharded``, ``train_step_sharded``), the scene's
instances a second one (``geometry.py``: ``render_sharded_2d``,
``train_step_sharded_2d``). The scene is replicated on every rank
(``sharding.replicate_scene``); gradients are summed by one all-reduce.
NCCL takes one rank per card; gloo carries several ranks on one card or
on the CPU.
"""

from clraytracer_tpu_torch.parallel.sharding import (  # noqa: F401
    make_device_mesh,
    render_sharded,
    train_step_sharded,
)
