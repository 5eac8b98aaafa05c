"""Per-device pipeline autotuning, and the devices a mesh is built from.

The port of the JAX package's ``runtime/platform.py``: its autotuning half,
and ``set_host_device_count`` with ``local_devices``.
The best (tile edge, chunk_group) point of the tiled engine
(``core/engine.py:EngineOptions``) depends on the device (the CPU wants
cache-sized groups, the card dispatch-amortizing ones), so ``autotune``
sweeps a caller-provided timing function over a small grid once and caches
the winner in ``<cache_dir>/<device key>.json``; ``load_autotune`` lets
later runs adopt it without sweeping again.

The JAX package names the cache file by ``jax.default_backend()``; the port
names it by the device the engine runs on (``device_key``): ``cpu``, or
``cuda-sm<major><minor>`` from the card's compute capability, so
``cuda-sm90`` on an H100. The JSON layout is JAX's: ``backend`` (the key),
``tile``, ``chunk_group``, ``wall_s`` and ``sweep``.

``set_host_device_count(n)`` is the counterpart of JAX's flag
``--xla_force_host_platform_device_count``: like it, it affects the host
(CPU) platform only, where ``local_devices(torch.device("cpu"))`` then
lists ``n`` entries of the one ``cpu`` device, so a tile mesh of several
entries runs on the CPU as JAX's tests run theirs on virtual host devices.
``local_devices`` of a ``cuda`` device lists every card. Unlike the XLA
flag it takes effect at any time: a mesh reads it when it is built.

``set_platform`` picks the process's platform, as JAX's picks its
backend: ``"gpu"`` (the card, the default) or ``"cpu"``, which is then
what every entry point's ``device=None`` means
(``utils.device.resolve_device``); the serving CLI's ``--platform``
calls it, as JAX's calls its own. What does not carry over: JAX's
function also writes ``XLA_FLAGS`` (async collectives, the latency-hiding
scheduler, Triton GEMM fusion), read when XLA's backend starts; PyTorch
runs eagerly and has no such compiler flags, and nothing here sets
``XLA_FLAGS``. JAX's default is ``"cpu"``; the port's stays the card.

``process_group`` opens the ``torch.distributed`` world of the LM's
multi-rank half (``runtime/sharding.py``, ``runtime/pipeline_parallel.py``,
``optim/compression.py``), one process a rank: ``gloo`` on the CPU,
``nccl`` on the card, rendezvous through a ``file://`` store in a
directory the caller names (never a fixed TCP port, so worlds started side
by side do not collide), closed when the block ends. Nothing falls back:
a failed ``nccl`` start raises.
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager
from datetime import timedelta
from typing import Callable, Iterable, Optional

import torch

from repro_torch.utils.device import resolve_device

#: Default location of the per-device autotune cache (relative to cwd).
AUTOTUNE_DIR = ".autotune"

#: Entries the CPU platform lists (``set_host_device_count``).
_host_device_count = 1


def set_platform(platform: str = "gpu") -> None:
    """Make ``device=None`` mean the card (``"gpu"``; it still raises
    where there is none) or the CPU (``"cpu"``) for the whole process.
    Any other name raises ``ValueError``."""
    from repro_torch.utils import device

    if platform not in ("gpu", "cpu"):
        raise ValueError(f"platform must be 'gpu' or 'cpu', got {platform!r}")
    device._DEFAULT = "cuda" if platform == "gpu" else "cpu"


def set_host_device_count(n: int) -> None:
    """Make the CPU platform list ``n`` entries (``local_devices``)."""
    global _host_device_count
    if int(n) < 1:
        raise ValueError(f"host device count must be >= 1, got {n}")
    _host_device_count = int(n)


def host_device_count() -> int:
    """The entries the CPU platform lists (1 unless set)."""
    return _host_device_count


def local_devices(device=None) -> list:
    """The devices of ``device``'s platform a mesh may take, in order:
    ``cuda:0`` … ``cuda:{count - 1}`` for a card (``None`` is the card,
    through ``resolve_device``), ``host_device_count()`` entries of
    ``cpu`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        return [torch.device("cpu")] * _host_device_count
    return [dev]


def device_key(device=None) -> str:
    """``cpu``, or ``cuda-sm<major><minor>`` for a card (``None`` is the
    card, through ``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    major, minor = torch.cuda.get_device_capability(dev)
    return f"cuda-sm{major}{minor}"


def _cache_path(cache_dir: str, device) -> str:
    """Per-device cache file: CPU and card winners never collide."""
    return os.path.join(cache_dir, f"{device_key(device)}.json")


def load_autotune(cache_dir: str = AUTOTUNE_DIR, device=None) -> Optional[dict]:
    """Return the cached winner for ``device``, or None.

    The dict carries ``tile``, ``chunk_group``, ``wall_s`` and the full
    ``sweep`` it won (see ``autotune``). Corrupt/partial cache files read
    as None: the caller just falls back to defaults.
    """
    try:
        with open(_cache_path(cache_dir, device)) as f:
            out = json.load(f)
        if "tile" in out and "chunk_group" in out:
            return out
    except (OSError, ValueError):
        pass
    return None


def autotune(
    run_fn: Callable[[int, int], float],
    tiles: Iterable[int] = (128, 256),
    groups: Iterable[int] = (1, 2),
    cache_dir: str = AUTOTUNE_DIR,
    force: bool = False,
    device=None,
) -> dict:
    """Sweep ``run_fn(tile, chunk_group) → wall seconds``; cache the winner.

    A deliberately small grid: the knobs interact with the device's memory
    hierarchy, not with correctness (every point produces bit-identical
    decisions), so a handful of timed points per device suffices. Returns
    ``{"backend", "tile", "chunk_group", "wall_s", "sweep": [...]}`` and
    persists it at ``<cache_dir>/<device key>.json`` unless an existing
    cache already answers (``force=True`` sweeps again).
    """
    if not force:
        cached = load_autotune(cache_dir, device)
        if cached is not None:
            return cached
    sweep = []
    for tile in tiles:
        for group in groups:
            wall = float(run_fn(int(tile), int(group)))
            sweep.append({"tile": int(tile), "chunk_group": int(group),
                          "wall_s": round(wall, 4)})
    best = min(sweep, key=lambda r: r["wall_s"])
    out = {"backend": device_key(device), "tile": best["tile"],
           "chunk_group": best["chunk_group"], "wall_s": best["wall_s"],
           "sweep": sweep}
    os.makedirs(cache_dir, exist_ok=True)
    with open(_cache_path(cache_dir, device), "w") as f:
        json.dump(out, f, indent=2)
    return out


@contextmanager
def process_group(rank: int, world_size: int, store_dir: str, device=None,
                  timeout_s: float = 120.0):
    """Open this process's rank of a ``world_size``-rank world for the
    block and yield its device: ``gloo`` for ``device="cpu"``, ``nccl``
    for the card (``None``; rank r takes ``cuda:r`` unless ``device``
    names an index). Every rank passes the same ``store_dir``; the store
    file in it must be new to this world. The group is destroyed when the
    block ends, also on an error."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(store_dir), "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    try:
        yield dev
    finally:
        dist.destroy_process_group()


__all__ = ["AUTOTUNE_DIR", "autotune", "device_key", "host_device_count",
           "load_autotune", "local_devices", "process_group",
           "set_host_device_count", "set_platform"]
