"""The Model API: init / forward / prefill / caches / decode, and the carrier
of the JAX package's parameters into the port (``params_from_jax``).

Parameters keep the JAX package's layout and tree — ``embed`` (V, D), also
the tied output head, ``final_norm`` (D,), and ``segments``, one dict per
layer-plan segment with every leaf stacked over a leading layer
dimension — so a test can hand the same numbers to both packages. They are
a plain tree passed to each call, as in JAX; the ``Model`` module holds the
configuration and the device. ``loss`` waits for training (ROADMAP A14).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTENTION_IMPLS, ModelConfig
from repro_torch.models.common import DTYPES, cast_tree, make_rope, rms_norm, tree_map
from repro_torch.models.transformer import (
    check_kind,
    init_segment,
    init_segment_cache,
    run_segment,
    run_segment_decode,
)
from repro_torch.utils.device import resolve_device


class Model(nn.Module):
    """A decoder-only LM of the configured architecture, on ``device``
    (default ``cuda``; ``"cpu"`` runs the plain PyTorch path)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                             f"got {cfg.attention_impl!r}")
        for kind, _ in cfg.plan:
            check_kind(kind)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0):
        """Random parameters from ``seed``, drawn on the model's device."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = {
            "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                                 device=self.device) * 0.02,
            "final_norm": torch.zeros((cfg.d_model,), device=self.device),
            "segments": [init_segment(gen, kind, count, cfg)
                         for kind, count in cfg.plan],
        }
        return cast_tree(params, DTYPES[cfg.param_dtype])

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(device=self.device, dtype=torch.long)

    def _head(self, params):
        return params["embed"].T                 # tied embeddings

    # --------------------------------------------------------------- forward
    def _stack(self, params, tokens):
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        tokens = self._tokens(tokens)
        x = params["embed"][tokens].to(dt)
        rope = make_rope(torch.arange(tokens.shape[1], device=self.device),
                         cfg.resolved_head_dim, cfg.rope_theta)
        for seg_params, (kind, _) in zip(params["segments"], cfg.plan):
            x = run_segment(kind, seg_params, x, rope, cfg)
        return rms_norm(x, params["final_norm"])

    def forward(self, params, tokens):
        """tokens (B, S) → logits (B, S, vocab) float32."""
        x = self._stack(params, tokens)
        return x.to(torch.float32) @ self._head(params).to(torch.float32)

    def prefill(self, params, tokens):
        """Serving prefill: last-position logits (B, vocab) only — the
        (B, S, vocab) logits tensor never exists."""
        x = self._stack(params, tokens)[:, -1]
        return x.to(torch.float32) @ self._head(params).to(torch.float32)

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16):
        return [init_segment_cache(kind, count, self.cfg, batch, seq_len,
                                   dtype=dtype, device=self.device)
                for kind, count in self.cfg.plan]

    def decode_step(self, params, cache, tokens, pos):
        """tokens (B,), pos an int or a (B,) per-row position vector →
        (logits (B, vocab) float32, cache). The cache is updated in place
        and returned."""
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        tokens = self._tokens(tokens)
        if not isinstance(pos, torch.Tensor) and np.ndim(pos) > 0:
            pos = torch.as_tensor(np.asarray(pos))
        if isinstance(pos, torch.Tensor):
            pos = (pos.to(device=self.device, dtype=torch.long) if pos.dim()
                   else int(pos))
        x = params["embed"][tokens[:, None]].to(dt)
        for seg_params, seg_cache, (kind, _) in zip(params["segments"], cache,
                                                    cfg.plan):
            x, _ = run_segment_decode(kind, seg_params, x, seg_cache, pos, cfg)
        x = rms_norm(x, params["final_norm"])
        logits = x[:, 0].to(torch.float32) @ self._head(params).to(torch.float32)
        return logits, cache


def greedy_decode(model: Model, params, prompt_tokens, n_new: int,
                  cache_len: Optional[int] = None):
    """Reference serving loop: the prompt is stepped through ``decode_step``
    one token at a time (exercising the decode path end to end), then
    ``n_new`` greedy tokens follow. Returns (B, S0 + n_new) tokens."""
    cfg = model.cfg
    prompt = model._tokens(prompt_tokens)
    B, S0 = prompt.shape
    total = S0 + n_new
    cache = model.init_cache(B, cache_len or total, dtype=DTYPES[cfg.dtype])
    tok = prompt[:, 0]
    out = [tok]
    for t in range(total - 1):
        logits, cache = model.decode_step(params, cache, tok, t)
        nxt = torch.argmax(logits, dim=-1)
        tok = prompt[:, t + 1] if t + 1 < S0 else nxt
        out.append(tok)
    return torch.stack(out, dim=1)


def params_from_jax(tree, device=None):
    """The JAX package's ``Model.init`` parameters (a tree of dicts and lists
    whose leaves are arrays; pass them through ``np.asarray``) as the port's
    parameters on ``device`` (default ``cuda``): the same tree, the same
    layout, the same dtypes and values."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":           # ml_dtypes, not a numpy type
            return torch.tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
        return torch.tensor(a, device=dev)

    return tree_map(leaf, tree)
