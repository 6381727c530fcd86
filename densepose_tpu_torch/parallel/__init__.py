"""Frames over devices: streaming inference over frame sequences
(``pipeline``), data-parallel frames and the spatial sharding of one frame
(``mesh``), and the row slabs and halo exchange the latter runs on
(``halo``)."""

from .mesh import data_parallel_forward, spatial_parallel_forward  # noqa: F401
