"""Serving CLI of the port: LM prefill and batched greedy decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve --task lm \
        --arch llama3.2-1b --batch 4 --prompt-len 128 --new-tokens 32

runs on the card (``--device cuda``, the default) with random weights from
seed 0: one ``Model.prefill`` of the prompts (the flash-attention kernel,
one launch per layer), then ``greedy_decode``, which steps the prompts and
the new tokens through the KV-cached decode path. ``--reduced`` serves a
smoke-test size (2 layers, d_model 256, head_dim 64); ``--device cpu``
runs the plain PyTorch path. The
``detect`` task of the JAX package's CLI waits for the port of the
detection service (ROADMAP A11).
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
        # 4 heads of 64: the kernel takes head_dim 64 or 128
        cfg = cfg.reduced(d_model=256, d_ff=512)
    model = Model(cfg, device=args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)))

    ops.flash_attention_fwd.launches = 0
    _sync(model.device)
    t0 = time.perf_counter()
    model.prefill(params, prompts)
    _sync(model.device)
    dt = time.perf_counter() - t0
    print(f"[serve] prefill {tuple(prompts.shape)} on {model.device} in "
          f"{dt:.3f}s ({args.batch * args.prompt_len / dt:.0f} tok/s), "
          f"{ops.flash_attention_fwd.launches} flash-attention kernel launches")

    t0 = time.perf_counter()
    out = greedy_decode(model, params, prompts, args.new_tokens)
    _sync(model.device)
    dt = time.perf_counter() - t0
    total = args.batch * (args.prompt_len + args.new_tokens)
    print(f"[serve] {tuple(out.shape)} tokens in {dt:.1f}s "
          f"({total / dt:.0f} tok/s, prompt stepped through decode)")
    print(out[:, :16].cpu().numpy())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=("lm",), default="lm",
                    help="lm (the detect task waits for the service port)")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    serve_lm(ap.parse_args())


if __name__ == "__main__":
    main()
