"""Driver ``clients``: a closed loop of clients against one detection
service that holds the cell's world as its resident corpus.

``clients`` client threads each submit a request of ``rows_per_request``
query rows, wait for its response and submit the next. Each row is a new
source drawn as the configuration's generator draws one of its world
(``data.new_sources``: its accuracies, coverage profile, and copiers at
its share and selectivity), from (data seed, client, k), renumbered by the
run's relabelling and given the world's truth probabilities; so every
request is distinct and every seed plays the same requests. The service
batches up to ``max_batch_requests`` requests a pass (``service_options``
go to it).

Set-up builds the service and serves ``warm_batches`` full batches through
``flush``. The window opens with every client's first request queued
before the worker starts, so batches are full from the first; clients
stop submitting once ``seconds`` have passed, and the window ends with
the last response. A unit is one request, from its submit to its
response; one that raises, or gets no response within ``timeout_s``, has
failed. Every response is judged.
"""
from __future__ import annotations

import threading
import time

from cdbench import check as cmp
from cdbench import data


def _request(ctx, state, client: int, k: int, rid: int):
    from repro_torch.core.serving import DetectRequest
    v, a, _ = data.new_sources(
        ctx.base_world, ctx.spec, int(ctx.traffic["rows_per_request"]),
        seed=[int(ctx.config["data_seed"]), int(client), int(k), 0x5E],
        claims_per_source=state["claims_per_source"])
    v = ctx.relabel.values(v)
    return DetectRequest(rid=rid, values=v, accuracy=a,
                         p_claim=data.claim_probs(v, ctx.truth))


def setup(ctx) -> dict:
    from repro_torch.core.serving import DetectionService
    t = ctx.traffic
    state = {"answers": [],
             "claims_per_source": (ctx.base_world.values >= 0).sum(axis=1)}
    svc = DetectionService(ctx.dataset(), ctx.p_claim, ctx.copy_config(),
                           mode=t["mode"],
                           max_batch_requests=int(t["max_batch_requests"]),
                           device=ctx.device, **t.get("service_options", {}))
    n_clients, per = int(t["clients"]), int(t["max_batch_requests"])
    for b in range(int(t.get("warm_batches", 1))):
        for j in range(per):
            svc.submit(_request(ctx, state, n_clients + b * per + j, 0, -1))
        svc.flush()
    state["service"] = svc
    return state


def window(ctx, state, seconds: float, run) -> None:
    from repro_torch.core.serving import ServiceStats
    from cdbench.harness import Unit
    t = ctx.traffic
    svc = state["service"]
    timeout = float(t["timeout_s"])
    n_clients = int(t["clients"])
    lock = threading.Lock()
    svc.stats = ServiceStats()
    firsts = []
    run.window_t0 = time.perf_counter()
    for c in range(n_clients):
        req = _request(ctx, state, c, 0, c)
        t_sub = time.perf_counter()
        firsts.append((req, t_sub, svc.submit(req, timeout=timeout)))

    def client(c: int) -> None:
        req, t_sub, fut = firsts[c]
        k = 0
        while True:
            stats = {"client": c}
            try:
                if isinstance(fut, Exception):
                    raise fut
                resp = fut.result(timeout=timeout)
                stats["batch"] = resp.batch_requests
            except Exception as exc:                  # noqa: BLE001
                resp, stats["error"] = None, repr(exc)
            t_done = time.perf_counter()
            with lock:
                run.units.append(Unit(t0=t_sub, t1=t_done,
                                      ok=resp is not None, stats=stats))
                if resp is not None:
                    state["answers"].append((req, resp))
            if t_done - run.window_t0 >= seconds:
                return
            k += 1
            req = _request(ctx, state, c, k, k * n_clients + c)
            t_sub = time.perf_counter()
            try:
                fut = svc.submit(req, timeout=timeout)
            except Exception as exc:                  # noqa: BLE001
                fut = exc                   # refused: the unit has failed

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(n_clients)]
    svc.start()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        svc.stop()
    run.window_t1 = max(u.t1 for u in run.units)
    run.extra["service"] = st = svc.stats
    # every request is distinct, so the result cache should never hit
    run.extra["notes"] = [f"service batches {st.batches} cache_hits "
                          f"{st.cache_hits} cache_misses {st.cache_misses}"]


def release(ctx, state) -> None:
    svc = state.pop("service", None)
    if svc is not None:
        svc.stop()


def check(ctx, state, run, control: bool = False) -> dict:
    import torch
    w, m, dev = ctx.world, ctx.model, ctx.device
    numbers = []
    for req, resp in state["answers"]:
        args = (req.values, req.p_claim, req.accuracy, w.values, ctx.p_claim,
                w.accuracy, m, dev)
        ref = cmp.rows_reference(*args)
        if control:
            answer = cmp.control_rows(
                cmp.rows_reference(*args, dtype=torch.bfloat16), m)
        else:
            answer = (resp.c_fwd, resp.copying, resp.intra_copying)
        numbers.append(cmp.judge_rows(*answer, ref, m))
    return cmp.merge(numbers)
