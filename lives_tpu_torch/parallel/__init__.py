"""Multi-device rendering over an explicit device mesh: frame-batch DP,
spatial bands, the band sweep, a pipeline over the chain, stateful bands
(counterpart of `lives_tpu/parallel/__init__.py`)."""

from .mesh import (BAND_SAFE_STATEFUL, Mesh, chain_band_halo,
                   chain_band_halo_stateful, frame_mesh, grid_batch_fn,
                   grid_mesh, pipeline_chain_fn, shard_layer_batch,
                   sharded_batch_fn, spatial_batch_fn, spatial_blur_sharded,
                   spatial_stateful_fn, spatial_sweep_fn)
from .dryrun import dryrun_multichip
