"""Parallelism on torch.distributed: the device mesh, its sharding rules,
the data-parallel step and mesh-fed data.

Port of ``joint_vae_tpu/parallel/``: data parallelism over the batch axis,
a 'model' axis splitting the class-conditional prior dictionary and the
classifier head, and a 'sample' axis splitting an evaluation's latent
samples, with one rank per device and explicit collectives
(``mesh.py``)."""

from .mesh import (make_mesh, batch_sharding, replicated,  # noqa: F401
                   state_shardings, distributed_init)
