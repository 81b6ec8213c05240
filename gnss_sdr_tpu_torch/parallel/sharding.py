"""Channel sharding over devices.

Counterpart of ``gnss_sdr_tpu/parallel/sharding.py``. The dominant
parallelism in a GNSS receiver is the satellite-channel axis: tracking
state is channel-local (no cross-channel arithmetic in the hot loop), so
channels shard over devices with nothing exchanged between shards. The
sample window is replicated (every channel correlates against the same
antenna stream); the per-period rows are gathered back on the channel
axis.

A mesh here is an ordered tuple of ``torch.device``s, one per shard. A
device may appear more than once: several shards then share one device,
which is how the CPU tests and a one-card host hold more than one shard.
Shard ``i`` takes the contiguous channel range
``[i * C / n, (i + 1) * C / n)``.

Where the JAX package runs a sharded block as one SPMD program (and keeps
it on the XLA scan, since its Pallas kernel would need ``shard_map``),
``make_sharded_track_block`` launches the engine once per shard, each on
its own device: the fused engine (K1, or K2 under
``GNSS_SDR_TPU_FUSED=perchannel``) where ``tracking/fused.py::
fused_eligible`` allows it on the card, and the eager engine (K3 a
period) otherwise. It is also the Tracker's engine without a mesh: one
shard on the Tracker's own device, which runs the engine on the whole
state with nothing split or gathered.

Placement: ``device_mesh`` puts a receiver's shards on the cards (one a
card unless told to share fewer, and raises when the host has too few),
``rank_device`` a process's rank on one.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from gnss_sdr_tpu_torch import canonical_device, resolve_device
from gnss_sdr_tpu_torch.tracking.conf import DllPllConf
from gnss_sdr_tpu_torch.tracking.dll_pll import TrackingState, track_block
from gnss_sdr_tpu_torch.tracking.fused import (
    _pack_scalars,
    build_fused_engine,
    fused_eligible,
    fused_track_block,
    launch_fused,
    unpack_rows,
)

CHANNEL_AXIS = "ch"


@dataclass(frozen=True)
class ChannelMesh:
    """The shards' devices, in channel order: the one mesh axis, the JAX
    mesh's ``CHANNEL_AXIS``."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> list[torch.device]:
        """Each device once, in first-use order."""
        return list(dict.fromkeys(self.devices))

    def ranges(self, channels: int) -> list[tuple[int, int]]:
        """The contiguous [start, stop) channel range of each shard; raises
        ``ValueError`` unless ``channels`` divides over the shards."""
        n = self.size
        if channels % n:
            raise ValueError(
                f"{channels} channels do not divide over {n} devices")
        per = channels // n
        return [(i * per, (i + 1) * per) for i in range(n)]


def make_channel_mesh(devices=None) -> ChannelMesh:
    """A mesh over ``devices`` (names or ``torch.device``s; repeats
    allowed), by default every CUDA device of the host. Raises
    ``RuntimeError`` for a CUDA device when no card is present."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(canonical_device(resolve_device(d)) for d in devices)
    if not devices:
        raise ValueError("a channel mesh needs at least one device")
    return ChannelMesh(devices)


def device_mesh(num_devices: int, device="cuda",
                cards: int | None = None) -> ChannelMesh:
    """A mesh of ``num_devices`` shards for an engine on ``device``. On
    CUDA the shards spread in contiguous runs over ``cards`` cards
    (``cuda:0`` .. ``cuda:cards-1``; by default one card a shard), which
    raises ``RuntimeError`` when the host has fewer (the JAX package's
    ``jax.devices()[:n]`` would shrink the mesh instead); on the CPU, n
    shards there."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return make_channel_mesh([dev] * num_devices)
    cards = num_devices if cards is None else cards
    have = torch.cuda.device_count()
    if cards > have:
        raise RuntimeError(
            f"num_devices={num_devices} but {have} CUDA device(s) present"
            if cards == num_devices else
            f"{cards} cards asked for but {have} CUDA device(s) present")
    return make_channel_mesh([f"cuda:{i * cards // num_devices}"
                              for i in range(num_devices)])


def rank_device(device, rank: int) -> torch.device:
    """The device of a process's ``rank``: card ``rank % count`` on CUDA
    (ranks share the cards when there are more ranks than cards), else
    the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _slice_state(state: TrackingState, a: int, b: int,
                 device: torch.device) -> TrackingState:
    """Channels [a, b) of ``state`` on ``device`` (views where the state
    already lies there)."""
    return TrackingState(**{f.name: getattr(state, f.name)[a:b].to(device)
                            for f in fields(TrackingState)})


def shard_state(state: TrackingState, mesh: ChannelMesh) -> list:
    """One state per shard: its channel range, on its device."""
    c = state.pos.shape[0]
    return [_slice_state(state, a, b, dev)
            for (a, b), dev in zip(mesh.ranges(c), mesh.devices)]


def gather_state(shards: list, device) -> TrackingState:
    """The shards' states concatenated on the channel axis on
    ``device``."""
    dev = torch.device(device)
    return TrackingState(**{
        f.name: torch.cat([getattr(s, f.name).to(dev) for s in shards])
        for f in fields(TrackingState)})


class ShardedTrackBlock:
    """One tracking block with the channels sharded over ``mesh``.

    ``__call__(state, window, *tables)`` has the engines' contract
    (``dll_pll.track_block``): ``state`` is the whole [C] state on one
    device, ``tables`` the [C, ...] code (and, in pilot mode, data-code
    and secondary) tables, and it returns the whole new state on the
    state's device and the [S, C] outputs there.

    The engine is the fused one where ``conf.fused_tracker`` says so, or
    by default where the mesh is on CUDA, and the plan allows it; else
    the eager one. A mesh of one shard on the state's device runs the
    engine on the whole state. Otherwise, per block, the window is copied
    once to each shard device other than its own and the tables are split
    and moved once, then kept until different tables are passed. The
    fused engine packs the whole state once, launches its kernel on each
    shard's rows of the packed block and unpacks the concatenated rows
    once; the eager engine runs on each shard's slice of the state.
    """

    def __init__(self, conf: DllPllConf, mesh: ChannelMesh) -> None:
        self.conf = conf
        self.mesh = mesh
        self.ranges = mesh.ranges(conf.max_channels)
        want = (conf.fused_tracker if conf.fused_tracker is not None
                else mesh.devices[0].type == "cuda")
        self.fused = bool(want) and fused_eligible(conf)
        self.spec = build_fused_engine(conf) if self.fused else None
        self._tables = None
        self._split = None

    def split_tables(self, tables: tuple) -> list:
        """Each shard's rows of ``tables`` on its device (cached for the
        same table tensors)."""
        if self._tables is None or len(self._tables) != len(tables) or any(
                a is not b for a, b in zip(self._tables, tables)):
            self._tables = tables
            self._split = [tuple(t[a:b].to(dev).contiguous() for t in tables)
                           for (a, b), dev in zip(self.ranges,
                                                  self.mesh.devices)]
        return self._split

    def __call__(self, state: TrackingState, window: torch.Tensor,
                 *tables: torch.Tensor) -> tuple[TrackingState, dict]:
        conf = self.conf
        home = canonical_device(state.pos.device)
        if self.mesh.devices == (home,):
            if self.fused:
                return fused_track_block(conf, self.spec, state, window,
                                         *tables)
            return track_block(conf, state, window, *tables)
        windows = {canonical_device(window.device): window}
        for dev in self.mesh.distinct():
            if dev not in windows:
                windows[dev] = window.to(dev)
        shards = list(zip(self.ranges, self.mesh.devices,
                          self.split_tables(tables)))
        if self.fused:
            scal = _pack_scalars(conf, state)
            rows = [launch_fused(self.spec, windows[dev], tabs[0],
                                 scal[a:b].to(dev), state.pos[a:b].to(dev),
                                 *tabs[1:]).to(home)
                    for (a, b), dev, tabs in shards]
            return unpack_rows(conf, state, torch.cat(rows))
        new, outs = [], []
        for (a, b), dev, tabs in shards:
            ns, o = track_block(conf, _slice_state(state, a, b, dev),
                                windows[dev], *tabs)
            new.append(ns)
            outs.append(o)
        merged = {k: torch.cat([o[k].to(home) for o in outs], dim=1)
                  for k in outs[0]}
        return gather_state(new, home), merged


def make_sharded_track_block(conf: DllPllConf,
                             mesh: ChannelMesh) -> ShardedTrackBlock:
    """A tracking block with the state and code tables split over the mesh
    on the channel axis and the window replicated; outputs concatenated on
    the channel axis. No collectives in the hot loop. The engine is
    chosen as ``ShardedTrackBlock`` says."""
    return ShardedTrackBlock(conf, mesh)
