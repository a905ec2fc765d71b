"""Multi-device execution over ``torch.distributed`` (mirrors
``pysparselp_tpu/parallel/``): the 1-D :class:`~.mesh.Mesh`, the row-sharded
DIA operators (:mod:`.sharded_dia`), the row-sharded CP-PPD solver
(:mod:`.sharded_cp`) and its position-sharded regime for aligned DIA
grids (:mod:`.sharded_cp_windowed`), the column-sharded interior point
(:mod:`.sharded_mehrotra`), the row-sharded ADMM chunks
(:mod:`.sharded_admm`), dual gradient ascent (:mod:`.sharded_dga`) and the
blocked dual coordinate ascent with its colour groups split over the ranks
(:mod:`.sharded_dca`)."""
