"""Data parallelism over torch.distributed (demo2_tpu/parallel/): the world,
the rows each rank feeds, and the collectives that make a step of W ranks
the one-process step on the global batch."""

from .collectives import Shard, data_parallel
from .mesh import World, join_process_group, make_world
from .multihost import HostShardedBatches, host_batch_rows, is_primary, iter_index_batches
