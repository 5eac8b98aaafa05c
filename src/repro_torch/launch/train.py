"""Training CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 100 --batch 4 --seq 2048 --checkpoint-dir ckpt

runs on the card (``--device cuda``, the default) from random weights
drawn from seed 0: the flash-attention kernels on the forward, its
recompute under ``remat`` and the backward, AdamW, checkpoint/restart.
``--reduced`` trains a smoke-test size (2 layers, d_model 256, head_dim
64); ``--device cpu`` runs the plain PyTorch path. The corpus's documents
hold ``--seq`` + 1 tokens, so every row trains on ``--seq`` tokens.
``--fusion-weighted`` first runs copy detection and truth finding over the
corpus's content-hashed spans (``data/fusion_weights.py``, on the same
device) and samples documents by the source and duplication weights it
derives. ``--arch falcon-mamba-7b`` and ``--arch hymba-1.5b`` train the
SSM block kinds through the chunk-checkpointed scan
(``models/mamba.py:SelectiveScan``); ``--arch gemma-2b`` (head_dim 256)
and ``--arch phi3.5-moe-42b-a6.6b`` (the ``moe`` kind) train like the
others. The optimizer is the config's: AdamW, or Adafactor for
grok-1-314b (``optim/adafactor.py``; like JAX's CLI, this one has no
flag that picks another). The conditioned archs (musicgen-large,
llama-3.2-vision-11b) raise ``ValueError`` before anything is built:
their ``cond`` comes from a conditioning frontend (an EnCodec/T5 or
vision encoder) that neither package has, and JAX's CLI feeds no
``cond`` either and fails inside its cross attention (ROADMAP C21). A
``cross`` model trains through ``runtime.train`` with batches that carry
``cond``.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--fusion-weighted", action="store_true",
                    help="derive source weights via copy detection first")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import Prefetcher, batches, synthetic_corpus
    from repro_torch.models import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.train_loop import train

    cfg = get_config(args.arch)
    if cfg.cond_len:
        raise ValueError(
            f"{cfg.name} attends over a conditioning input cond (B, "
            f"{cfg.cond_len}, {cfg.cond_dim}) that a conditioning frontend "
            f"(an EnCodec/T5 or vision encoder) would make; neither package "
            f"has one, and the token corpus carries none (ROADMAP C21): "
            f"train it through runtime.train with batches that carry cond")
    get_optimizer(cfg.optimizer)
    if args.reduced:
        # 4 heads of 64: the kernels take head_dim 64, 128 or 256
        cfg = cfg.reduced(d_model=256, d_ff=512)
    model = Model(cfg, device=args.device)

    corpus = synthetic_corpus(vocab_size=cfg.vocab_size, doc_len=args.seq + 1,
                              seed=0)
    src_w = doc_w = None
    if args.fusion_weighted:
        from repro_torch.data.fusion_weights import fusion_weights
        src_w, doc_w, _ = fusion_weights(corpus, device=args.device)
        print(f"[train] fusion weights: src range "
              f"[{src_w.min():.2f}, {src_w.max():.2f}]")
    data = batches(corpus, args.batch, args.seq, source_weights=src_w,
                   doc_weights=doc_w)
    if args.grad_accum > 1:
        base = data

        def accum():
            while True:
                ms = [next(base) for _ in range(args.grad_accum)]
                yield {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        data = accum()

    prefetch = Prefetcher(data)
    try:
        state, history = train(
            model, prefetch, steps=args.steps, peak_lr=args.lr,
            grad_accum=args.grad_accum, checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every)
    finally:
        prefetch.close()
    print(f"[train] finished at step {int(state['step'])}, "
          f"final loss {history[-1]['loss']:.4f}")
    return state, history


if __name__ == "__main__":
    main()
