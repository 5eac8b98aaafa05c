"""Serving CLI of the port: LM decoding and copy-detection serving.

  --task lm (default): LM prefill and batched greedy decoding.

      PYTHONPATH=src python -m repro_torch.launch.serve --task lm \
          --arch llama3.2-1b --batch 4 --prompt-len 128 --new-tokens 32

      runs on the card (``--device cuda``, the default) with random weights
      from seed 0: one ``Model.prefill`` of the prompts (the flash-attention
      kernel, one launch per attention layer), then ``greedy_decode``, which
      steps the prompts and the new tokens through the cached decode path.
      ``--arch`` is any of the registry's (``repro_torch.configs.ARCH_IDS``):
      ``llama3.2-1b``, ``qwen2.5-3b`` and ``starcoder2-15b`` (dense, QKV
      bias), ``gemma-2b`` (dense, one kv head, head_dim 256, GeGLU),
      ``phi3.5-moe-42b-a6.6b`` and ``grok-1-314b`` (mixture of
      experts), ``falcon-mamba-7b`` (Mamba layers only), ``hymba-1.5b``
      (attention and Mamba heads in every layer, a sliding window on 29 of
      32), ``musicgen-large`` and ``llama-3.2-vision-11b`` (cross
      attention). For the Mamba kinds the prompt length is a multiple of the
      scan chunk (64) or shorter. A conditioned arch (musicgen-large,
      llama-3.2-vision-11b) gets a conditioning input cond ~ N(0, 1) of
      (batch, cond_len, cond_dim) from the seeded generator, standing in for
      the EnCodec/T5 or vision frontend's embeddings, in the prefill and in
      every decode step. ``--reduced`` serves a smoke-test size (2 layers,
      d_model 256, attention head_dim 64); ``--device cpu`` runs the plain
      PyTorch path. Only the configs that fit one card run at full width.

  --task detect: the batched detection service (``core/serving.py``). A
      corpus is held in memory; concurrent requests — each a few query
      sources to be checked for copying against the corpus — are drained
      from a bounded queue and folded into ONE engine pass per batch (in
      ``bucketed`` mode the tiled pass, whose scan launches the fused
      copyscore kernel on the card), with per-request scatter of the
      decision matrix and backpressure at the submit edge.

      PYTHONPATH=src python -m repro_torch.launch.serve --task detect \
          --sources 512 --items 1536 --requests 32 --batch-requests 8

      prints req/s, engine passes and mean batch, latency p50/p99, the
      kernel's launches and device ms of the last pass, peak device memory
      and planted-copier hits. ``--device cpu`` serves on the CPU;
      ``--mode`` picks another engine mode.

      --commit-accepted commits every served request's accepted rows (no
      copying found) into the live corpus (delta-chunk re-index, no
      rebuild), re-serves the wave — repeats hit the invalidation-aware
      result cache — and prints ServiceStats. --replicas N serves through a
      ReplicaRouter with epoch-consistent commit broadcast; --shard-owners N
      through a shard-owner fleet whose tiled reads fan out per owner.

      --deadline-s attaches a per-request deadline: requests the admission
      controller predicts cannot be served in time are shed at submit,
      queued requests whose deadline passes expire typed, and the adaptive
      batch limit shrinks under pressure. --breaker-threshold /
      --breaker-cooldown-s tune the per-replica commit circuit breaker.

      --retract-last N retracts the N newest corpus rows after the serve
      and prints the retraction receipt.

      --state-dir makes the service durable: commits append to a fsync'd
      commit log and full snapshots land every --snapshot-every commits.
      When the directory already holds a manifest the service is RESTORED
      from it — latest valid snapshot + log-tail replay — instead of built
      from the synthetic corpus, and the restore receipt is printed. With
      --replicas each replica persists under its own replica-<i>/
      subdirectory.

      --devices N runs each pass's tile scan over the first N devices of
      the platform (default: all of them); --mesh-shape DATAxPOD over a 2-D
      mesh, tiles over data, each chunk group over pod. --host-devices N
      makes the CPU list N entries (``runtime.platform.
      set_host_device_count``), so a mesh runs with ``--device cpu``:

      PYTHONPATH=src python -m repro_torch.launch.serve --task detect \
          --device cpu --host-devices 4 --mesh-shape 2x2

  --platform gpu|cpu, as JAX's ``--platform``, sets what every
  ``device=None`` of the process means (``runtime.platform.set_platform``)
  before either task starts: ``--platform cpu`` serves wholly on the CPU,
  ``gpu`` (the default) on the card. ``--device`` names one device and
  wins over it.
"""
from __future__ import annotations

import argparse
import time


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(args):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model, greedy_decode

    cfg = get_config(args.arch)
    if args.reduced:
        # 4 heads of 64: the kernel takes head_dim 64, 128 or 256
        cfg = cfg.reduced(d_model=256, d_ff=512)
    model = Model(cfg, device=args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)))
    cond = None
    if cfg.cond_len:
        cond = torch.as_tensor(rng.normal(
            0, 1, (args.batch, cfg.cond_len, cfg.cond_dim)), dtype=torch.float32)

    ops.flash_attention_fwd.launches = 0
    _sync(model.device)
    t0 = time.perf_counter()
    model.prefill(params, prompts, cond=cond)
    _sync(model.device)
    dt = time.perf_counter() - t0
    print(f"[serve] prefill {tuple(prompts.shape)} on {model.device} in "
          f"{dt:.3f}s ({args.batch * args.prompt_len / dt:.0f} tok/s), "
          f"{ops.flash_attention_fwd.launches} flash-attention kernel launches")

    t0 = time.perf_counter()
    out = greedy_decode(model, params, prompts, args.new_tokens, cond=cond)
    _sync(model.device)
    dt = time.perf_counter() - t0
    total = args.batch * (args.prompt_len + args.new_tokens)
    print(f"[serve] {tuple(out.shape)} tokens in {dt:.1f}s "
          f"({total / dt:.0f} tok/s, prompt stepped through decode)")
    print(out[:, :16].cpu().numpy())


def serve_detect(args):
    import os

    import numpy as np
    import torch

    from repro_torch.core import CopyConfig, DurabilityOptions
    from repro_torch.core.serving import (
        DeadlineExceeded,
        DetectionService,
        DetectRequest,
        ReplicaRouter,
        ServiceOverloaded,
    )
    from repro_torch.data.claims import (
        SyntheticSpec,
        oracle_claim_probs,
        synthetic_claims,
        synthetic_query_rows,
    )
    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = CopyConfig(alpha=0.1, s=0.8, n=50.0)
    spec = SyntheticSpec(n_sources=args.sources, n_items=args.items,
                         coverage="book", n_cliques=max(3, args.sources // 40),
                         clique_size=3, clique_items=12, seed=0)
    sc = synthetic_claims(spec)
    p = oracle_claim_probs(sc)
    q = args.rows_per_request
    vals, acc, pq, origins = synthetic_query_rows(
        sc, args.requests * q, seed=1)
    requests = [
        DetectRequest(rid=i, values=vals[i * q:(i + 1) * q],
                      accuracy=acc[i * q:(i + 1) * q],
                      p_claim=pq[i * q:(i + 1) * q],
                      deadline_s=args.deadline_s)
        for i in range(args.requests)
    ]
    service_kw = dict(
        mode=args.mode,
        max_batch_requests=args.batch_requests,
        max_pending_rows=args.max_pending_rows,
        tile=args.tile, devices=args.devices,
        prefetch_depth=args.prefetch_depth, device=device)
    if args.shards and args.shards > 1:
        # row-range-sharded corpus plane: each detection pass scans per
        # shard and merges; spill/bitpack bound residency
        service_kw.update(
            n_shards=args.shards, shard_pack=args.shard_pack,
            shard_spill_bytes=args.shard_spill_bytes,
            shard_spill_dir=args.shard_spill_dir)
    if args.mesh_shape:
        d, pod = (int(x) for x in args.mesh_shape.split("x"))
        service_kw["mesh_shape"] = (d, pod)
    if args.state_dir:
        service_kw["durability"] = DurabilityOptions(
            state_dir=args.state_dir, snapshot_every=args.snapshot_every)
    restorable = (args.state_dir and args.replicas <= 1
                  and not args.shard_owners and os.path.exists(
                      os.path.join(args.state_dir, "manifest.json")))
    if restorable:
        svc = DetectionService.restore(args.state_dir, device=device,
                                       devices=args.devices)
        ri = svc.restore_info
        print(f"[serve] restored {args.state_dir}: snapshot epoch "
              f"{ri.snapshot_epoch} + {ri.replayed_commits} replayed "
              f"commits in {ri.wall_s:.2f}s "
              f"({ri.discarded_bytes} torn-tail bytes discarded); "
              f"corpus {svc.resident.n_corpus} sources at epoch {svc.epoch}")
    elif args.shard_owners:
        # shard-owner fleet: each replica OWNS one row range of a single
        # shared sharded index; tiled fan-out modes scatter the scan per
        # owner and merge on the router
        svc = ReplicaRouter(sc.dataset, p, cfg,
                            shard_owners=args.shard_owners,
                            breaker_threshold=args.breaker_threshold,
                            breaker_cooldown_s=args.breaker_cooldown_s,
                            shard_pack=args.shard_pack,
                            shard_spill_bytes=args.shard_spill_bytes,
                            shard_spill_dir=args.shard_spill_dir,
                            **{k: v for k, v in service_kw.items()
                               if k not in ("n_shards", "shard_pack",
                                            "shard_spill_bytes",
                                            "shard_spill_dir")})
        print(f"[serve] shard-owner fleet: {args.shard_owners} owners, "
              f"placement {svc._owner_plan().bounds.tolist()}")
    elif args.replicas > 1:
        svc = ReplicaRouter(sc.dataset, p, cfg, n_replicas=args.replicas,
                            breaker_threshold=args.breaker_threshold,
                            breaker_cooldown_s=args.breaker_cooldown_s,
                            **service_kw)
    else:
        svc = DetectionService(sc.dataset, p, cfg, **service_kw)
    print(f"[serve] corpus {args.sources}×{args.items}, mode={args.mode}, "
          f"device={device}, replicas={args.replicas}, "
          f"batch≤{args.batch_requests} requests, "
          f"backpressure at {args.max_pending_rows} rows")

    def _services(s):
        return s.replicas if isinstance(s, ReplicaRouter) else [s]

    def _reset(s):
        # fresh stats AND caches so the timed run measures engine passes,
        # not warm-up leftovers
        for one in _services(s):
            one.stats = type(one.stats)()
            if one.cache is not None:
                one.cache = type(one.cache)(one.cache.max_entries)

    # warm-up with one full-size batch (the largest union shape), so the
    # timed run excludes the kernels' first build and load; capped at the
    # pending-row budget (nothing drains until the flush); reset stats so
    # the printed passes/mean-batch describe only the timed run
    n_warm = max(1, min(args.batch_requests, args.max_pending_rows // q))
    for r in requests[:n_warm]:
        # deadline-free clone: a tight --deadline-s must not shed the
        # warm-up
        svc.submit(DetectRequest(rid=f"warm-{r.rid}", values=r.values,
                                 accuracy=r.accuracy, p_claim=r.p_claim))
    svc.flush()
    _reset(svc)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    shed = expired = 0
    t0 = time.perf_counter()
    with svc:
        pairs = []
        for r in requests:
            try:
                pairs.append((r, svc.submit(r)))
            except (DeadlineExceeded, ServiceOverloaded):
                shed += 1
        served, results = [], []
        for r, f in pairs:
            try:
                results.append(f.result())
                served.append(r)
            except DeadlineExceeded:
                expired += 1
    dt = time.perf_counter() - t0

    hits = planted = 0
    for r, resp in zip(served, results):
        for row in range(q):
            o = int(origins[r.rid * q + row])
            if o >= 0:
                planted += 1
                hits += int(resp.copying[row, o])
    print(f"[serve] {len(results)}/{len(requests)} requests in {dt:.2f}s "
          f"({len(results) / dt:.1f} req/s), "
          f"{svc.stats.batches} engine passes "
          f"(mean batch {svc.stats.mean_batch:.1f})")
    if results:
        lat = np.array([r.latency_s for r in results])
        print(f"[serve] latency p50={np.percentile(lat, 50) * 1e3:.0f} ms "
              f"p99={np.percentile(lat, 99) * 1e3:.0f} ms; "
              f"planted copiers detected {hits}/{planted}")
    es = _services(svc)[0].engine.last_stats
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
            if device.type == "cuda" else "not measured (CPU)")
    print(f"[serve] last pass: {es.get('n_devices', 1)} mesh entries, "
          f"{es.get('kernel_launches', 0)} kernel "
          f"launches, {es.get('scan_kernel_ms', 0.0):.3f} ms kernel device "
          f"time, mask source {es.get('mask_source', '-')}; peak device "
          f"memory {peak}")
    if args.shards and args.shards > 1:
        print(f"[serve] shard plane: {es.get('n_shards')} shards "
              f"{es.get('shard_plan')}, peak resident/shard "
              f"{es.get('shard_peak_resident_bytes')} bytes")
    if args.deadline_s is not None:
        st = svc.stats
        limits = [s._batch_limit for s in _services(svc)]
        print(f"[serve] deadline {args.deadline_s * 1e3:.0f} ms: "
              f"{shed} shed at submit, {expired} expired in queue; "
              f"queue wait p50={st.queue_wait_p50 * 1e3:.0f} ms "
              f"p99={st.queue_wait_p99 * 1e3:.0f} ms; "
              f"batch limit {max(limits)} "
              f"({st.batch_shrinks} shrinks, {st.batch_grows} grows)")

    if args.commit_accepted:
        # fold the ACCEPTED rows into the live corpus — rows detection
        # cleared of copying (copier rows are rejected; independent rows
        # carry fresh evidence) — then re-serve the same wave: repeats whose
        # claims no commit touched come straight from the result cache
        t0 = time.perf_counter()
        n_acc = 0
        for r, resp in zip(served, results):
            keep = ~resp.copying.any(axis=1) & ~resp.intra_copying.any(axis=1)
            if keep.any():
                svc.commit(r.values[keep], r.accuracy[keep], r.p_claim[keep])
                n_acc += int(keep.sum())
        t_commit = time.perf_counter() - t0
        t0 = time.perf_counter()
        with svc:
            futs = []
            for r in requests:
                try:
                    futs.append(svc.submit(r))
                except (DeadlineExceeded, ServiceOverloaded):
                    pass
            for f in futs:
                try:
                    f.result()
                except DeadlineExceeded:
                    pass
        t_wave2 = time.perf_counter() - t0
        st = svc.stats
        corpus_rows = max(s.resident.n_corpus for s in _services(svc))
        print(f"[serve] committed {n_acc} accepted rows in {t_commit:.2f}s "
              f"({st.commits} commits, corpus now {corpus_rows} sources); "
              f"re-served wave in {t_wave2:.2f}s")
        print(f"[serve] ServiceStats: cache_hit_rate="
              f"{st.cache_hit_rate:.1%} ({st.cache_hits} hits / "
              f"{st.cache_misses} misses, "
              f"{st.cache_invalidations} invalidations), "
              f"delta_chunks={st.delta_chunks}, "
              f"new_entries={st.new_entries}, "
              f"reindexed_entries={st.reindexed_entries}, "
              f"compactions={st.compactions}")

    if args.retract_last:
        n = max(s.resident.n_corpus for s in _services(svc))
        k = min(args.retract_last, n - 1)
        row_ids = list(range(n - k, n))
        t0 = time.perf_counter()
        out = svc.retract(row_ids)
        t_retract = time.perf_counter() - t0
        info = (next(i for i in out if i is not None)
                if isinstance(out, list) else out)
        st = svc.stats
        print(f"[serve] retracted {info.rows} newest rows in "
              f"{t_retract * 1e3:.1f} ms: {info.touched_entries} index "
              f"entries re-scored, {info.gc_entries} GC'd, "
              f"{st.cache_invalidations} cache invalidations; corpus now "
              f"{max(s.resident.n_corpus for s in _services(svc))} sources "
              f"at epoch {max(s.epoch for s in _services(svc))}")
        if args.replicas > 1:
            print(f"[serve] breaker: trips={st.breaker_trips} "
                  f"open_now={st.breaker_open}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=("lm", "detect"), default="lm")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: what --platform names)")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default=None,
                    help="the process's platform (runtime.platform."
                         "set_platform): gpu, the card (the default), or cpu")
    # lm args
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="an arch of repro_torch.configs.ARCH_IDS (lm)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    # detect args
    ap.add_argument("--sources", type=int, default=256)
    ap.add_argument("--items", type=int, default=1024)
    ap.add_argument("--mode", default="bucketed",
                    help="DetectionEngine mode (bucketed, sample_verify, ...)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rows-per-request", type=int, default=4)
    ap.add_argument("--batch-requests", type=int, default=8,
                    help="requests folded into one engine pass")
    ap.add_argument("--max-pending-rows", type=int, default=256,
                    help="backpressure bound on queued query rows")
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--devices", type=int, default=None,
                    help="1-D tile-mesh size: the first N devices of the "
                         "platform (default: all)")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="entries the CPU platform lists "
                         "(runtime.platform.set_host_device_count)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="chunk groups the staging pipeline stages ahead of "
                         "the tile kernel; 0 = synchronous")
    ap.add_argument("--shards", type=int, default=None,
                    help="row-range shards of the corpus data plane; each "
                         "detection pass scans per shard and merges "
                         "bit-equal to unsharded")
    ap.add_argument("--shard-pack", action="store_true",
                    help="bitpack shard chunk blocks to 1 bit/entry "
                         "during scans (8x over int8)")
    ap.add_argument("--shard-spill-bytes", type=int, default=None,
                    help="per-shard resident byte cap; cold blocks spill "
                         "to checksummed frames (LRU)")
    ap.add_argument("--shard-spill-dir", default=None,
                    help="spill directory (default: the system temp "
                         "directory when a byte cap is set)")
    ap.add_argument("--mesh-shape", default=None,
                    help="2-D tile mesh DATAxPOD (e.g. 4x2): tiles over "
                         "data, entry chunks over pod")
    ap.add_argument("--commit-accepted", action="store_true",
                    help="after the first wave, commit every served "
                         "request's accepted rows into the live corpus "
                         "(delta-chunk re-index) and re-serve the wave; "
                         "prints ServiceStats incl. cache hit rate")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds: hopeless "
                         "requests are shed at submit, stale queued ones "
                         "expire typed")
    ap.add_argument("--retract-last", type=int, default=0,
                    help="after serving, retract the N newest corpus rows "
                         "and print the retraction receipt")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a ReplicaRouter with this many "
                         "DetectionService replicas (commits broadcast)")
    ap.add_argument("--shard-owners", type=int, default=None,
                    help="shard-owner fleet: this many replicas, each "
                         "OWNING one row range of a shared sharded index; "
                         "tiled fan-out modes scatter the scan per owner "
                         "and the router merges the partial grids")
    ap.add_argument("--breaker-threshold", type=int, default=5,
                    help="consecutive commit failures before a replica's "
                         "circuit breaker opens and it is ejected from "
                         "the broadcast (--replicas > 1)")
    ap.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                    help="seconds an open breaker waits before probing "
                         "the replica with a catch-up replay")
    ap.add_argument("--state-dir", default=None,
                    help="durable state directory (commit log + snapshots); "
                         "restored from when it already holds a manifest")
    ap.add_argument("--snapshot-every", type=int, default=16,
                    help="write a full snapshot every N commits "
                         "(0 = only the initial snapshot)")
    args = ap.parse_args(argv)
    from repro_torch.runtime.platform import (set_host_device_count,
                                              set_platform)
    if args.platform:
        set_platform(args.platform)
    if args.host_devices:
        set_host_device_count(args.host_devices)
    if args.task == "detect":
        serve_detect(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
