"""Data and tensor parallelism on ``torch.distributed`` (port of
``zonos_tpu/parallel/``): the mesh, the tp layouts and the tp collectives."""
