"""Multi-device execution over ``torch.distributed`` (mirrors
``pysparselp_tpu/parallel/``): the 1-D :class:`~.mesh.Mesh`, the row-sharded
DIA operators (:mod:`.sharded_dia`) and the row-sharded CP-PPD solver
(:mod:`.sharded_cp`)."""
