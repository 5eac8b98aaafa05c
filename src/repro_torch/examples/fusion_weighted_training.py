"""End-to-end driver: the paper's technique as an LM data-curation layer.

1. Build a synthetic multi-source corpus where copier sources re-host a
   low-quality original's documents (duplicated junk outweighs clean text).
2. Run copy detection + truth finding over content-hashed document claims
   (``data/fusion_weights.py``) → per-source accuracies + copy pairs.
3. Train the same small LM twice — uniform sampling vs fusion-weighted
   sampling — and compare clean-held-out loss.

  PYTHONPATH=src python -m repro_torch.examples.fusion_weighted_training \
      [--steps 200] [--d-model 256] [--large] [--device cpu]

Attention heads are 64 wide (``d_model // 64`` heads), a width the
flash-attention kernels take; ``--large`` is ~100M parameters.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import CopyConfig
from repro_torch.data.fusion_weights import fusion_weights
from repro_torch.data.tokens import Prefetcher, batches, synthetic_corpus
from repro_torch.models import Model
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.train_loop import init_train_state, make_train_step

HEAD_DIM = 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--large", action="store_true",
                    help="~100M-param config (slow on CPU)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.large:
        args.d_model, args.layers = 768, 12
    if args.d_model % HEAD_DIM:
        ap.error(f"--d-model must be a multiple of {HEAD_DIM}")

    # ------------------------------------------------------------ corpus
    corpus = synthetic_corpus(n_sources=24, docs_per_source=40, doc_len=128,
                              vocab_size=512, n_copiers=8, seed=0)
    print(f"corpus: {len(corpus.docs)} docs from 24 sources; "
          f"{len(corpus.copy_edges)} copier→original edges planted")

    # --------------------------------------------- copy detection → weights
    t0 = time.time()
    src_w, doc_w, fus = fusion_weights(
        corpus, CopyConfig(alpha=0.1, s=0.8, n=100.0), device=args.device)
    det = fus.detection.copying_pairs()
    planted = {(min(a, b), max(a, b)) for a, b in corpus.copy_edges}
    print(f"copy detection: {time.time() - t0:.1f}s, "
          f"planted recall {len(det & planted)}/{len(planted)}")
    corr = np.corrcoef(src_w, corpus.source_accuracy)[0, 1]
    print(f"estimated source quality vs planted accuracy: r={corr:.2f}")

    # -------------------------------------------------------------- train
    heads = args.d_model // HEAD_DIM
    cfg = (get_config("llama3.2-1b")
           .reduced(n_layers=args.layers, d_model=args.d_model,
                    d_ff=4 * args.d_model, vocab=corpus.vocab_size)
           .replace(n_layers=args.layers, layer_plan=(("dense", args.layers),),
                    n_heads=heads, n_kv_heads=heads))
    model = Model(cfg, device=args.device)
    n_params = sum(x.numel() for x in tree_leaves(model.init(0)))
    print(f"model: {n_params / 1e6:.1f}M params")

    # clean eval set: noise-free progressions
    rng = np.random.default_rng(99)
    starts = rng.integers(0, 512, (64, 1))
    strides = rng.integers(1, 5, (64, 1))
    ev = (starts + strides * np.arange(args.seq + 1)) % 512
    eval_batch = {"tokens": torch.from_numpy(ev[:, :-1].astype(np.int32)),
                  "labels": torch.from_numpy(ev[:, 1:].astype(np.int32))}

    def run(tag, source_weights, doc_weights):
        opt = adamw()
        step = make_train_step(model, opt, warmup_cosine(3e-3, 20, args.steps))
        state = init_train_state(model, opt, seed=0)
        it = Prefetcher(batches(corpus, args.batch, args.seq,
                                source_weights=source_weights,
                                doc_weights=doc_weights, seed=1))
        t0 = time.time()
        for s in range(args.steps):
            state, m = step(state, next(it))
            if s % 50 == 0:
                print(f"  [{tag}] step {s:4d} loss {float(m['loss']):.3f}")
        it.close()
        with torch.no_grad():
            eval_loss = float(model.loss(state["params"], eval_batch))
        print(f"  [{tag}] done in {time.time() - t0:.0f}s — "
              f"clean eval loss {eval_loss:.3f}")
        return eval_loss

    print("\n--- uniform sampling (copy-blind) ---")
    l_uniform = run("uniform", None, None)
    print("\n--- fusion-weighted sampling (the paper's technique) ---")
    l_weighted = run("weighted", src_w, doc_w)

    print(f"\nclean eval loss: uniform={l_uniform:.3f} → "
          f"weighted={l_weighted:.3f} "
          f"({'improved' if l_weighted < l_uniform else 'no gain'})")
    return {"uniform": l_uniform, "weighted": l_weighted}


if __name__ == "__main__":
    main()
