"""The language model for the dense and MoE families (plain PyTorch).

The counterpart of ``repro/models/model.py``'s ``LM`` for
``family in ("dense", "moe")``, with its functional interface:

    init(generator)                    -> params
    prefill(params, batch)             -> (cache, last_logits)
    decode_step(params, cache, batch)  -> (logits, cache)
    init_cache(batch, max_len)         -> zero cache

Parameters are nested dicts of tensors, laid out as the JAX package lays
them out (``[in, out]`` projections, ``[V, d]`` embedding) except that the
layers are a list of per-layer dicts instead of arrays stacked on axis 0;
``repro_torch.convert.lm_params_from_numpy`` carries the JAX pytree over.
The layer scans become Python loops.  Every other family raises
``NotImplementedError`` naming its ROADMAP item.  An MoE layer's router is
fp32 in the parameters and, as in the reference, cast with the rest to the
compute dtype (``_cast``); the routing then computes in fp32
(``repro_torch.models.moe.moe_route``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

PORTED_FAMILIES = ("dense", "moe")
UNPORTED_FAMILIES = {
    f: (f"the {f} family is not ported yet: ROADMAP.md Queue A item 8 "
        f"(A8.2: the ssm, hybrid, audio and vlm families)")
    for f in ("ssm", "hybrid", "audio", "vlm")}


class LM:
    """Dense or MoE decoder-only LM on ``device`` (CUDA unless told
    otherwise)."""

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                UNPORTED_FAMILIES.get(cfg.family, f"family {cfg.family!r}"))
        if cfg.attn_3d_kernels:
            raise NotImplementedError(
                "attn_3d_kernels ([d, H, hd] projections) is not ported: "
                "ROADMAP.md Queue A item 8")
        self.cfg = cfg
        self.device = resolve_device(device, "LM")

    # ------------------------------------------------------------------ #
    # Parameters.
    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``param_dtype``, drawn from ``generator``
        (which must live on the model's device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, the model "
                             f"on {self.device}")
        cfg = self.cfg
        dt = L._dtype(cfg.param_dtype)
        p: dict = {
            "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                      device=self.device),
            "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dt),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = L.dense_init(generator, cfg.d_model,
                                        cfg.vocab_size, dt)
        p["layers"] = [B.dense_block_params(generator, cfg)
                       for _ in range(cfg.num_layers)]
        return p

    def _cast(self, params):
        """Mixed precision: fp32 parameters compute in ``compute_dtype``
        (the MoE router too, as in the reference).  Pure and idempotent, so a caller may cast once and keep the copy
        (``PagedServer`` does); the numbers are those of a cast per call."""
        cd = L._dtype(self.cfg.compute_dtype)
        if cd == torch.float32:
            return params

        def cast(a):
            if isinstance(a, dict):
                return {k: cast(v) for k, v in a.items()}
            if isinstance(a, list):
                return [cast(v) for v in a]
            return a.to(cd) if a.dtype == torch.float32 else a

        return cast(params)

    # ------------------------------------------------------------------ #
    # Embedding / head.
    # ------------------------------------------------------------------ #
    def _embed(self, p, tokens):
        cfg = self.cfg
        x = p["embed"][tokens]
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.d_model)
        return x.to(L._dtype(cfg.compute_dtype))

    def _head_matrix(self, p):
        if self.cfg.tie_embeddings:
            return p["embed"].T  # [d, V]
        return p["lm_head"]

    def _logits(self, p, x):
        """fp32 products of the (compute-dtype) head: ``x [..., d]``."""
        return x.float() @ self._head_matrix(p).float()

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------------------------ #
    # Prefill / decode.
    # ------------------------------------------------------------------ #
    def init_cache(self, batch: int, max_len: int):
        spec = B.dense_cache_spec(self.cfg, batch, max_len)
        return {"layers": {
            name: torch.zeros((self.cfg.num_layers, *shape), dtype=dt,
                              device=self.device)
            for name, (shape, dt) in spec.items()}}

    @torch.no_grad()
    def prefill(self, params, batch, *, max_len: int | None = None):
        """Process the prompt, returning ``(cache, last-position logits)``.

        batch: ``{"tokens": [B, S]}``.  The cache is ``{"layers": {"k":
        [L, B, max_len or S, Hkv, hd], "v": ...}}``.
        """
        cfg = self.cfg
        params = self._cast(params)
        x = self._embed(params, self._tokens(batch["tokens"]))
        s = x.shape[1]
        ml = max_len or s
        positions = torch.arange(s, device=self.device)
        ks, vs = [], []
        for lp in params["layers"]:
            x, k, v = B.dense_block_prefill(lp, cfg, x, positions, ml)
            ks.append(k)
            vs.append(v)
        cache = {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return cache, self._logits(params, x[:, -1])

    @torch.no_grad()
    def decode_step(self, params, cache, batch):
        """One token for every sequence.  batch: ``tokens [B]``, ``lengths
        [B]``.  Returns ``(logits [B, V], cache)``; the cache is updated in
        place (the JAX version returned an updated copy)."""
        cfg = self.cfg
        params = self._cast(params)
        tokens = self._tokens(batch["tokens"])
        lengths = self._tokens(batch["lengths"])
        x = self._embed(params, tokens[:, None])
        ck, cv = cache["layers"]["k"], cache["layers"]["v"]
        for i, lp in enumerate(params["layers"]):
            x, _ = B.dense_block_decode(lp, cfg, x, {"k": ck[i], "v": cv[i]},
                                        lengths)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x)[:, 0], cache
