"""Data, tensor and sequence parallelism: device meshes for serving,
process groups for training (``mesh.py``), channel-sharded state and the
column-parallel operators (``tp.py``), time-sharded activations and the
halo exchanges of the convs (``sp.py``)."""

from .mesh import (FlatGrads, Mesh, RowGenerator, all_gather,
                   all_reduce_flat, all_reduce_max, all_reduce_sum, barrier,
                   broadcast_, broadcast_module, canonical, check_divisible,
                   data_extent, data_group, data_rank, data_world,
                   device_mesh, distributed, draw_rows, grid_ranks,
                   init_distributed, is_main, make_mesh, model_group,
                   model_rank, model_world, rank, replica_group,
                   replica_root, replica_world, seq_group, seq_rank,
                   seq_world, set_grid, shard_rows, world)
from .tp import MODEL_AXIS, gather_state, model_axis_spec, shard_module

__all__ = ['FlatGrads', 'MODEL_AXIS', 'Mesh', 'RowGenerator', 'all_gather',
           'all_reduce_flat', 'all_reduce_max', 'all_reduce_sum', 'barrier',
           'broadcast_', 'broadcast_module', 'canonical', 'check_divisible',
           'data_extent', 'data_group', 'data_rank', 'data_world',
           'device_mesh', 'distributed', 'draw_rows', 'gather_state',
           'grid_ranks', 'init_distributed', 'is_main', 'make_mesh',
           'model_axis_spec', 'model_group', 'model_rank', 'model_world',
           'rank', 'replica_group', 'replica_root', 'replica_world',
           'seq_group', 'seq_rank', 'seq_world', 'set_grid',
           'shard_module', 'shard_rows', 'world']
