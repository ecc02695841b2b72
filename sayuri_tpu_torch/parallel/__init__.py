"""Data parallelism over ``torch.distributed``, one process a GPU (port of
sayuri_tpu.parallel): the mesh and its sharding helpers (``mesh``), the
process group and its collectives (``distributed``), and the multi-rank
dry run (``dryrun``)."""

from sayuri_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
