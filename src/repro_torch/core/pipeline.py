"""Async double-buffered chunk staging for the tiled engine.

The tiled engine streams entry-chunk groups host→device: assemble a
``(S_pad, G, b)`` v-slab on the host, move it to the device, run the tile
kernel. Done synchronously, the kernel idles for the full staging time of
every group. ``ChunkPrefetcher`` runs the staging on a producer thread a
configurable ``depth`` of groups ahead, so group G+1's host copy and
transfer hide behind group G's compute. It is the JAX package's prefetcher
unchanged.

``SlabRing`` is what the port's stage function stages into: a few slots of
(host slab, device slabs), reused round robin. A slot's host slab holds the
group's chunks cut into the slices of a tile mesh's ``pod`` axis (one slice
for a 1-D mesh), and each slice is placed once on every distinct device
that reads it (``core/distributed.py:MeshTileScan.places``). On the card
the host slabs are pinned and each slot's uploads run on a side CUDA stream
of each device, so a staged slab is in flight while the previous group's
kernels run. A host slab is refilled only after its last uploads have
completed, and a device slab only after every kernel launch that read it
(each device's side stream waits on an event recorded behind the launches
on that device). On the CPU the device slabs are the host slices
themselves, which the kernel's plain version reads.

Telemetry (all wall seconds, accumulated across the pass):

  * ``staging_s``   — time the producer spent assembling + transferring;
  * ``stage_wait_s``— time the CONSUMER blocked waiting for a staged group
    (pipeline stall: staging is the bottleneck);
  * ``compute_wait_s`` — time the PRODUCER blocked on a full queue
    (compute is the bottleneck — the healthy state).

``depth=0`` degrades to fully synchronous staging in the consumer's
thread; ``stage_wait_s`` then equals ``staging_s`` by construction, which
is what makes "prefetch hides staging" a measurable claim
(``stage_wait_s`` with prefetch < ``staging_s`` without).

A raising stage function surfaces as a typed ``PipelineStageError`` on the
consumer side (original exception chained); ``close`` always reaps the
thread and drains staged payloads so no device buffers are stranded.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable

import torch

#: Sentinel kinds flowing through the queue alongside staged payloads.
_ITEM, _DONE, _ERROR = "item", "done", "error"


class PipelineStageError(RuntimeError):
    """A prefetch stage thread failed; the original exception is chained."""


class ChunkPrefetcher:
    """Iterate staged payloads, staging up to ``depth`` groups ahead.

    ``stage_fn(descriptor)`` runs on the producer thread (``depth`` ≥ 1) or
    inline (``depth=0``) and returns the staged payload. The iterator
    yields payloads in descriptor order and raises ``PipelineStageError``
    if a stage failed. Always ``close()`` in a finally block.
    """

    def __init__(self, descriptors: Iterable, stage_fn: Callable,
                 depth: int = 2):
        """Start staging ``descriptors`` through ``stage_fn``."""
        self.stage_wait_s = 0.0
        self.compute_wait_s = 0.0
        self.staging_s = 0.0
        self._stage_fn = stage_fn
        self._depth = max(int(depth), 0)
        self._stop = False
        self.thread = None
        if self._depth == 0:
            self._it = iter(descriptors)
            return
        self._descs = list(descriptors)
        self.q: queue.Queue = queue.Queue(maxsize=self._depth)
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    # -- producer ------------------------------------------------------------

    def _put(self, payload) -> bool:
        """Queue-put that never blocks past a ``close()``; False = stopped."""
        while not self._stop:
            try:
                self.q.put(payload, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self) -> None:
        try:
            for d in self._descs:
                if self._stop:
                    return
                t0 = time.perf_counter()
                staged = self._stage_fn(d)
                self.staging_s += time.perf_counter() - t0
                t1 = time.perf_counter()
                ok = self._put((_ITEM, staged))
                self.compute_wait_s += time.perf_counter() - t1
                if not ok:
                    return
            self._put((_DONE, None))
        except BaseException as exc:  # surfaced typed on the consumer side
            self._put((_ERROR, exc))

    # -- consumer ------------------------------------------------------------

    def __iter__(self):
        """Iterator protocol — the engine's group loop is a plain for."""
        return self

    def __next__(self):
        """Next staged payload; blocks until staged (timed as stall)."""
        if self._depth == 0:
            d = next(self._it)           # StopIteration ends the loop
            t0 = time.perf_counter()
            try:
                staged = self._stage_fn(d)
            except StopIteration:
                raise
            except BaseException as exc:
                raise PipelineStageError(
                    f"chunk staging failed: {exc!r}") from exc
            dt = time.perf_counter() - t0
            self.staging_s += dt
            self.stage_wait_s += dt      # consumer waited the full time
            return staged
        t0 = time.perf_counter()
        while True:
            try:
                kind, payload = self.q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self.thread.is_alive():
                    raise PipelineStageError(
                        "prefetch stage thread died without a result")
        self.stage_wait_s += time.perf_counter() - t0
        if kind == _DONE:
            raise StopIteration
        if kind == _ERROR:
            raise PipelineStageError(
                f"chunk staging failed: {payload!r}") from payload
        return payload

    def close(self) -> None:
        """Stop the stage thread and drop staged payloads (device buffers).

        Idempotent; safe mid-iteration (the engine calls it in a finally on
        success AND failure paths). Draining the queue releases every
        already-staged device array so an aborted pass strands nothing.
        """
        self._stop = True
        if self.thread is None:
            return
        for _ in range(2):               # drain → join → drain again
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            if self.thread.is_alive():
                self.thread.join(timeout=5.0)


class SlabRing:
    """``n`` staging slots of one pass, used round robin by group number.

    Each slot holds an int8 slab of ``shape`` = (pods, rows, Kp, w): the
    group's chunks in ``pods`` contiguous slices of Kp, a (pods, 3, Kp)
    float32 metadata buffer (p̂, δ, non-Ē a slice) and an (``n_coords``, 2)
    int32 tile list. ``places[p]`` lists the distinct devices that read
    slice ``p``; the tile list goes to every device of ``places``. The
    producer calls ``acquire`` (blocks until the slot's last readers have
    launched), fills ``host[i]``/``host_meta[i]``/``host_coords[i]`` and
    calls ``upload``; the consumer calls ``use`` before the launches that
    read the slot and ``release`` right after them. ``slot_wait_s`` is the
    producer's time blocked on a slot still in use (compute holding staging
    back).
    """

    def __init__(self, n: int, shape: tuple, n_coords: int, places: list):
        self.n = int(n)
        pods, _, kp, _ = shape
        if len(places) != pods:
            raise ValueError(f"{pods} slices need {pods} placements, got "
                             f"{len(places)}")
        self.places = [list(devs) for devs in places]
        self.devices = []
        for devs in self.places:
            self.devices += [d for d in devs if d not in self.devices]
        self.cuda = [d for d in self.devices if d.type == "cuda"]
        pin = bool(self.cuda)

        def host(shape_, dtype):
            return [torch.empty(shape_, dtype=dtype, pin_memory=pin)
                    for _ in range(self.n)]
        self.host = host(shape, torch.int8)
        self.host_meta = host((pods, 3, kp), torch.float32)
        self.host_coords = host((n_coords, 2), torch.int32)

        def placed(src, dev):
            if dev.type != "cuda":
                return src
            t = torch.empty_like(src, device=dev)
            # written on the side stream: the allocator must not hand the
            # memory out again before those copies are done
            t.record_stream(self.stream[dev])
            return t
        self.stream = {d: torch.cuda.Stream(d) for d in self.cuda}
        self.dev = [{(p, d): placed(self.host[i][p], d)
                     for p, devs in enumerate(self.places) for d in devs}
                    for i in range(self.n)]
        self.dev_meta = [{(p, d): placed(self.host_meta[i][p], d)
                          for p, devs in enumerate(self.places) for d in devs}
                         for i in range(self.n)]
        self.dev_coords = [{d: placed(self.host_coords[i], d)
                            for d in self.devices} for i in range(self.n)]
        self.copied = [{d: torch.cuda.Event() for d in self.cuda}
                       for _ in range(self.n)]
        self.read = [{d: torch.cuda.Event() for d in self.cuda}
                     for _ in range(self.n)]
        self._free = [threading.Event() for _ in range(self.n)]
        for ev in self._free:
            ev.set()
        self.closed = False
        self.slot_wait_s = 0.0

    def acquire(self, i: int) -> None:
        """Producer: wait until slot ``i`` may be refilled. Raises once the
        ring is closed (the pass ended or failed)."""
        t0 = time.perf_counter()
        while not self._free[i].wait(0.05):
            if self.closed:
                raise RuntimeError("slab ring closed")
        self._free[i].clear()
        for d in self.cuda:
            self.copied[i][d].synchronize()   # the host slab's last upload is done
        self.slot_wait_s += time.perf_counter() - t0

    def upload(self, i: int) -> None:
        """Producer: copy slot ``i``'s host buffers to each card on its side
        stream, behind the launches that last read its device buffers."""
        for d in self.cuda:
            with torch.cuda.device(d), torch.cuda.stream(self.stream[d]):
                self.stream[d].wait_event(self.read[i][d])
                pairs = [(self.dev_coords[i][d], self.host_coords[i])]
                for p, devs in enumerate(self.places):
                    if d in devs:
                        pairs += [(self.dev[i][p, d], self.host[i][p]),
                                  (self.dev_meta[i][p, d],
                                   self.host_meta[i][p])]
                for dst, src in pairs:
                    dst.copy_(src, non_blocking=True)
                self.copied[i][d].record(self.stream[d])

    def use(self, i: int) -> tuple:
        """Consumer: slot ``i``'s device (slabs, metas, coords) — keyed
        ``(slice, device)``, ``(slice, device)`` and ``device`` — with each
        card's current stream ordered behind their upload."""
        for d in self.cuda:
            torch.cuda.current_stream(d).wait_event(self.copied[i][d])
        return self.dev[i], self.dev_meta[i], self.dev_coords[i]

    def release(self, i: int) -> None:
        """Consumer: every launch reading slot ``i`` is enqueued; the slot
        may be refilled behind them."""
        for d in self.cuda:
            self.read[i][d].record(torch.cuda.current_stream(d))
        self._free[i].set()

    def close(self) -> None:
        """Wake and fail a producer still waiting for a slot."""
        self.closed = True


__all__ = ["ChunkPrefetcher", "PipelineStageError", "SlabRing"]
