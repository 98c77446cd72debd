"""Multi-device scaling: device mesh + sharded sample reductions.

The reference is single-process (SURVEY.md §2.6); this package is the
multi-device scaling layer it never had. Chains are sharded on the sample
axis across a ``jax.sharding.Mesh``; every sample-linear reduction (fine
histograms, weighted moments, N_eff lag terms) runs per-shard under
``shard_map`` and is combined with a single ``psum`` of the small binned
state (1024 or 256^2 grids). Post-binning KDE work is
grid-local and replicated — no large cross-device tensors exist anywhere
in the pipeline.
"""

from getdist_tpu.parallel.mesh import make_mesh, shard_samples
from getdist_tpu.parallel.reductions import (
    sharded_moments,
    sharded_hist_1d,
    sharded_pair_hists,
    sharded_triangle_step,
)

__all__ = [
    "make_mesh",
    "shard_samples",
    "sharded_moments",
    "sharded_hist_1d",
    "sharded_pair_hists",
    "sharded_triangle_step",
]
