"""Data parallelism: device meshes for serving, process groups for
training (``mesh.py``)."""

from .mesh import (FlatGrads, Mesh, RowGenerator, all_gather,
                   all_reduce_flat, all_reduce_max, all_reduce_sum, barrier,
                   broadcast_, broadcast_module, canonical, check_divisible,
                   device_mesh, distributed, draw_rows, init_distributed,
                   is_main, make_mesh, rank, shard_rows, world)

__all__ = ['FlatGrads', 'Mesh', 'RowGenerator', 'all_gather',
           'all_reduce_flat', 'all_reduce_max', 'all_reduce_sum', 'barrier',
           'broadcast_', 'broadcast_module', 'canonical', 'check_divisible',
           'device_mesh', 'distributed', 'draw_rows', 'init_distributed',
           'is_main', 'make_mesh', 'rank', 'shard_rows', 'world']
