"""Channel sharding over devices (``parallel/sharding.py``), the
multi-process run over ``torch.distributed`` (``parallel/distributed.py``)
and the multi-device dry run (``parallel/dryrun.py``)."""

from gnss_sdr_tpu_torch.parallel.sharding import (
    CHANNEL_AXIS,
    ChannelMesh,
    ShardedTrackBlock,
    device_mesh,
    gather_state,
    make_channel_mesh,
    make_sharded_track_block,
    rank_device,
    shard_state,
)

__all__ = [
    "CHANNEL_AXIS",
    "ChannelMesh",
    "ShardedTrackBlock",
    "device_mesh",
    "gather_state",
    "make_channel_mesh",
    "make_sharded_track_block",
    "rank_device",
    "shard_state",
]
