"""The Model API: init / forward / loss / prefill / caches / decode, and the
carriers of the JAX package's parameters and train state into the port
(``params_from_jax``, ``train_state_from_jax``).

Parameters keep the JAX package's layout and tree — ``embed`` (V, D), also
the output head where ``cfg.tie_embeddings``, else ``lm_head`` (D, V),
``final_norm`` (D,), and ``segments``, one dict per layer-plan segment
with every leaf stacked over a leading layer dimension — so a test can
hand the same numbers to both packages. They are a plain tree passed to
each call, as in JAX; the ``Model`` module holds the configuration and
the device. ``loss`` is differentiable: autograd through
the flash-attention Function (``kernels.ops.FlashAttention``) on the
kernel path (the cross attention's too, whose k and v are projected from
``cond``), the chunk-checkpointed scan (``mamba.SelectiveScan``) of the
SSM kinds and the expert loop of the ``moe`` kind (its gathers and
``index_add_``; routing recomputed under ``remat`` from the same input
picks the same experts), and with ``cfg.remat`` through per-layer
checkpoints: every block kind trains. A configuration with ``cond_len``
(the ``cross`` kind's conditioning, precomputed frame or patch embeddings
(B, cond_len, cond_dim)) takes ``cond`` in ``forward``, ``prefill``,
``decode_step``, ``greedy_decode`` and the batch of ``loss``, cast to the
compute dtype.

``param_dims`` and ``cache_dims`` name every leaf's dims for the sharding
rules (``runtime/sharding.py``), and ``input_specs`` gives meta stand-ins
for a shape's inputs; ``Model(cfg, device="meta").init()`` gives every
parameter's shape and dtype without memory.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTENTION_IMPLS, ModelConfig, ShapeConfig
from repro_torch.models.common import (
    DTYPES,
    MetaGenerator,
    cast_tree,
    make_rope,
    randn,
    rms_norm,
    tree_map,
)
from repro_torch.models.transformer import (
    check_kind,
    init_segment,
    init_segment_cache,
    run_segment,
    run_segment_decode,
    segment_cache_dims,
    segment_dims,
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
        """Random parameters from ``seed``, drawn on the model's device; on
        the ``meta`` device, their shapes and dtypes only."""
        cfg = self.cfg
        gen = (MetaGenerator() if self.device.type == "meta" else
               torch.Generator(device=self.device).manual_seed(seed))
        params = {
            "embed": randn(gen, (cfg.vocab_size, cfg.d_model)) * 0.02,
            "final_norm": torch.zeros((cfg.d_model,), device=self.device),
            "segments": [init_segment(gen, kind, count, cfg)
                         for kind, count in cfg.plan],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = randn(gen, (cfg.d_model, cfg.vocab_size)) * 0.02
        return cast_tree(params, DTYPES[cfg.param_dtype])

    def param_dims(self):
        """The logical dims of every parameter (``runtime/sharding.py``)."""
        cfg = self.cfg
        dims = {
            "embed": ("vocab", "d_model"),
            "final_norm": ("d_model",),
            "segments": [segment_dims(kind, cfg) for kind, _ in cfg.plan],
        }
        if not cfg.tie_embeddings:
            dims["lm_head"] = ("d_model", "vocab")
        return dims

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(device=self.device, dtype=torch.long)

    def _cond(self, cond):
        """``cond`` as a tensor in the compute dtype on the model's device;
        a plan with a ``cross`` segment needs one."""
        if cond is None:
            if any(kind == "cross" for kind, _ in self.cfg.plan):
                raise ValueError(f"{self.cfg.name} has cross-attention layers: "
                                 f"pass cond (B, {self.cfg.cond_len}, "
                                 f"{self.cfg.cond_dim})")
            return None
        if not isinstance(cond, torch.Tensor):
            cond = torch.as_tensor(np.asarray(cond))
        return cond.to(device=self.device, dtype=DTYPES[self.cfg.dtype])

    def _head(self, params):
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    # --------------------------------------------------------------- forward
    def _stack(self, params, tokens, cond=None):
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        tokens = self._tokens(tokens)
        x = params["embed"][tokens].to(dt)
        cond = self._cond(cond)
        rope = make_rope(torch.arange(tokens.shape[1], device=self.device),
                         cfg.resolved_head_dim, cfg.rope_theta)
        for seg_params, (kind, _) in zip(params["segments"], cfg.plan):
            x = run_segment(kind, seg_params, x, rope, cfg, cond=cond)
        return rms_norm(x, params["final_norm"])

    def forward(self, params, tokens, cond=None):
        """tokens (B, S) → logits (B, S, vocab) float32."""
        x = self._stack(params, tokens, cond=cond)
        return x.to(torch.float32) @ self._head(params).to(torch.float32)

    def loss(self, params, batch):
        """batch: {tokens (B, S), labels (B, S), cond?} → mean token
        cross-entropy (a float32 scalar) over the full float32 logits, as
        the JAX package's ``Model.loss`` computes it: logsumexp minus the
        gold logit, averaged. Every block kind trains; a plan with
        ``cross`` layers needs ``batch["cond"]`` (B, cond_len,
        cond_dim)."""
        logits = self.forward(params, batch["tokens"], cond=batch.get("cond"))
        labels = self._tokens(batch["labels"])
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(lse - gold)

    def prefill(self, params, tokens, cond=None):
        """Serving prefill: last-position logits (B, vocab) only — the
        (B, S, vocab) logits tensor never exists."""
        x = self._stack(params, tokens, cond=cond)[:, -1]
        return x.to(torch.float32) @ self._head(params).to(torch.float32)

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16):
        return [init_segment_cache(kind, count, self.cfg, batch, seq_len,
                                   dtype=dtype, device=self.device)
                for kind, count in self.cfg.plan]

    def cache_dims(self):
        """The logical dims of every cache leaf (``init_cache``'s tree)."""
        return [segment_cache_dims(kind) for kind, _ in self.cfg.plan]

    def decode_step(self, params, cache, tokens, pos, cond=None):
        """tokens (B,), pos an int or a (B,) per-row position vector, cond
        (B, cond_len, cond_dim) where the plan has ``cross`` layers →
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
        cond = self._cond(cond)
        for seg_params, seg_cache, (kind, _) in zip(params["segments"], cache,
                                                    cfg.plan):
            x, _ = run_segment_decode(kind, seg_params, x, seg_cache, pos, cfg,
                                      cond=cond)
        x = rms_norm(x, params["final_norm"])
        logits = x[:, 0].to(torch.float32) @ self._head(params).to(torch.float32)
        return logits, cache


    # ---------------------------------------------------------- input specs
    def input_specs(self, shape: ShapeConfig,
                    per_host_batch: Optional[int] = None) -> dict:
        """Meta tensors standing in for every model input of ``shape``
        (the JAX package's ``ShapeDtypeStruct`` stand-ins): tokens and
        labels (train), tokens (prefill), tokens and pos (decode), and
        cond where the config has a conditioning length."""
        cfg = self.cfg
        B = per_host_batch or shape.global_batch

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        specs = {}
        if shape.kind == "train":
            specs["tokens"] = meta((B, shape.seq_len), torch.int32)
            specs["labels"] = meta((B, shape.seq_len), torch.int32)
        elif shape.kind == "prefill":
            specs["tokens"] = meta((B, shape.seq_len), torch.int32)
        else:
            specs["tokens"] = meta((B,), torch.int32)
            specs["pos"] = meta((), torch.int32)
        if cfg.cond_len:
            specs["cond"] = meta((B, cfg.cond_len, cfg.cond_dim),
                                 DTYPES[cfg.dtype])
        return specs


def greedy_decode(model: Model, params, prompt_tokens, n_new: int, cond=None,
                  cache_len: Optional[int] = None):
    """Reference serving loop: the prompt is stepped through ``decode_step``
    one token at a time (exercising the decode path end to end), then
    ``n_new`` greedy tokens follow. Returns (B, S0 + n_new) tokens."""
    cfg = model.cfg
    prompt = model._tokens(prompt_tokens)
    B, S0 = prompt.shape
    total = S0 + n_new
    cache = model.init_cache(B, cache_len or total, dtype=DTYPES[cfg.dtype])
    cond = model._cond(cond)
    tok = prompt[:, 0]
    out = [tok]
    for t in range(total - 1):
        logits, cache = model.decode_step(params, cache, tok, t, cond=cond)
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


def train_state_from_jax(state, device=None):
    """The JAX package's train state ``{params, opt, step}`` (``opt`` is
    AdamW's ``{m, v[, master]}`` or Adafactor's ``{f[, master]}``; leaves
    through ``np.asarray``) as the port's on ``device``:
    the same trees, dtypes and values, with ``step`` an int64 scalar."""
    dev = resolve_device(device)
    return {"params": params_from_jax(state["params"], dev),
            "opt": params_from_jax(state["opt"], dev),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int64, device=dev)}
