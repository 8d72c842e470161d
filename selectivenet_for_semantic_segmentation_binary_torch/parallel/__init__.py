"""Several cards (JAX counterpart: ``parallel/``): ``multihost`` joins a
fleet of one process a card for training and evaluation; ``mesh`` holds
the fleet's checks and reductions and splits a batch over the cards of one
process for serving; ``spatial`` splits the image rows (the spatial
forward over a mesh of entries, and the halo exchange of ``--sp_ways``)."""

from .spatial import (  # noqa: F401
    make_mesh_2d,
    spatial_forward,
    spatial_forward_2d,
)
