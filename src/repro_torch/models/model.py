"""The language model over every family of the reference (plain PyTorch).

The counterpart of ``repro/models/model.py``'s ``LM``, with its functional
interface:

    init(generator)                    -> params
    backbone(params, x, batch)         -> (final-normed hidden, aux)
    loss(params, batch)                -> (scalar, {"xent", "aux"})
    cache_specs(batch, max_len)        -> the cache's (shape, dtype) tree
    init_cache(batch, max_len)         -> zero cache
    prefill(params, batch)             -> (cache, last_logits)
    decode_step(params, cache, batch)  -> (logits, cache)

Families: dense and moe (a stack of transformer blocks), audio (the same
stack over summed codebook embeddings with sinusoidal positions, one head
per codebook), vlm (groups of self-attention blocks, each followed by a
gated cross-attention block over the image embeddings), ssm (xLSTM: groups
of mLSTM blocks, each followed by an sLSTM block) and hybrid (zamba2:
groups of Mamba2 blocks, each followed by one weight-tied attention block,
then a tail of Mamba2 blocks).

Parameters are nested dicts of tensors, laid out as the JAX package lays
them out (``[in, out]`` projections) except that the reference's stacked
layers become lists: ``layers``, ``cross_layers``, ``slstm`` and
``mamba_tail`` are lists of per-layer dicts; ``self_layers``, ``mlstm`` and
``mamba`` lists of groups, each a list of per-layer dicts; ``shared_attn``
is one dict.  ``repro_torch.convert.lm_params_from_numpy`` carries the JAX
pytree over.  The layer scans become Python loops.  Caches keep the
reference's stacked layout (``[G, P, B, ...]``, ``[G, B, ...]``, ``[L, B,
...]``); ``decode_step`` updates the cache it is given in place (the JAX
version returned an updated copy).

``backbone`` and ``loss`` run under autograd (with ``remat``, each layer
or group is recomputed in the backward, at the reference's
``jax.checkpoint`` sites); ``prefill`` and ``decode_step`` under
``no_grad``.  Mixed precision as in the reference:
``_cast`` casts every fp32 leaf to the compute dtype, the fp32-drawn gate
biases, ``a_log``, ``d_skip``, ``dt_bias`` and the MoE router included.
``attn_3d_kernels`` gives the ``[d, H, hd]`` projections (the 2-D init's
numbers reshaped, as in the reference).

``param_specs()`` and ``input_specs(shape)`` give the parameter and batch
trees as meta tensors (the dry run's shape-only inputs); the dry run runs
``loss``, ``prefill`` and ``decode_step`` on meta DTensors, so the code
here writes into no buffer that is not a DTensor itself (``prefill``
takes the cache to fill).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.telemetry.spans import clock

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def sinusoidal_positions(positions: torch.Tensor, d: int, dtype):
    """The reference's sinusoidal table ``[len(positions), d]`` at the given
    rows only (sin on even columns, cos on odd), computed in fp32."""
    pos = positions.float()[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    # Interleaved by a stack (no writes into a buffer: the dry run's
    # positions are DTensors).
    out = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return out.reshape(pos.shape[0], d).to(dtype)


class _MetaGenerator(torch.Generator):
    """A generator that says it is on meta: ``init``'s draws then give meta
    tensors, which meta kernels make without drawing (torch has no meta
    generator of its own)."""

    @property
    def device(self):
        return torch.device("meta")


def _lookup(tokens, table):
    """``table[tokens]`` (``F.embedding``).  A DTensor table is replicated
    first (an all-gather; its gradient a reduce-scatter): DTensor's
    vocabulary-sharded lookup leaves a masked partial sum that remat's
    recomputation and the backward cannot always reduce."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(table, DTensor):
        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    return F.embedding(tokens, table)


def _stack(spec, *dims):
    """A per-layer cache spec stacked on leading ``dims``."""
    return {k: ((*dims, *shape), dt) for k, (shape, dt) in spec.items()}


def _at(node, *idx):
    """One layer's cache, as views of the stacked tensors."""
    return {k: v[idx] for k, v in node.items()}


def _put(node, idx, state):
    """Write one layer's state into the stacked cache."""
    for k, v in state.items():
        node[k][idx].copy_(v)


class LM:
    """A decoder of any family on ``device`` (CUDA unless told otherwise)."""

    def __init__(self, cfg: ModelConfig, device=None, remat: bool = False):
        f = cfg.family
        if f not in FAMILIES:
            raise ValueError(f"unknown family {f!r}")
        self.cfg = cfg
        self.device = resolve_device(device, "LM")
        self.remat = remat  # recompute each layer (group) in the backward
        # The grouped layouts of the interleaved families.
        if f == "ssm":
            if not cfg.slstm_every or cfg.num_layers % cfg.slstm_every:
                raise ValueError("ssm needs num_layers a multiple of "
                                 "slstm_every")
            self.n_groups = cfg.num_layers // cfg.slstm_every
            self.per_group = cfg.slstm_every - 1  # mLSTM blocks per group
        elif f == "vlm":
            if not cfg.cross_attn_every:
                raise ValueError("vlm needs cross_attn_every")
            self.n_groups = cfg.num_layers // cfg.cross_attn_every
            self.per_group = cfg.cross_attn_every
        elif f == "hybrid":
            if not cfg.shared_attn_every:
                raise ValueError("hybrid needs shared_attn_every")
            self.n_groups = cfg.num_layers // cfg.shared_attn_every
            self.per_group = cfg.shared_attn_every
            self.n_tail = cfg.num_layers - self.n_groups * self.per_group

    # ------------------------------------------------------------------ #
    # Parameters.
    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``param_dtype`` (the few leaves the
        reference draws in fp32 stay fp32), drawn from ``generator``, which
        must live on the model's device."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator is on {generator.device}, the model "
                             f"on {self.device}")
        return self._init(generator)

    def param_specs(self) -> dict:
        """The tree ``init`` gives, as meta tensors of its shapes and
        dtypes, drawing nothing.  Works at any width."""
        return self._init(_MetaGenerator())

    def _init(self, gen) -> dict:
        cfg = self.cfg
        dt = L._dtype(cfg.param_dtype)
        f = cfg.family
        audio = f == "audio"
        p: dict = {"final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                             device=gen.device)}
        if audio:
            p["embed"] = torch.stack([
                L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
                for _ in range(cfg.num_codebooks)])  # [K, V, d]
        else:
            p["embed"] = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
        if not cfg.tie_embeddings:
            if audio:
                p["lm_head"] = torch.stack([
                    L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
                    for _ in range(cfg.num_codebooks)])  # [K, d, V]
            else:
                p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                            dt)

        def groups(make):
            return [[make(gen, cfg) for _ in range(self.per_group)]
                    for _ in range(self.n_groups)]

        if f in ("dense", "moe", "audio"):
            p["layers"] = [B.dense_block_params(gen, cfg, i)
                           for i in range(cfg.num_layers)]
        elif f == "vlm":
            p["self_layers"] = groups(B.dense_block_params)
            p["cross_layers"] = [B.cross_block_params(gen, cfg)
                                 for _ in range(self.n_groups)]
        elif f == "ssm":
            p["mlstm"] = groups(B.mlstm_block_params)
            p["slstm"] = [B.slstm_block_params(gen, cfg)
                          for _ in range(self.n_groups)]
        elif f == "hybrid":
            p["mamba"] = groups(B.mamba2_block_params)
            if self.n_tail:
                p["mamba_tail"] = [B.mamba2_block_params(gen, cfg)
                                   for _ in range(self.n_tail)]
            p["shared_attn"] = B.dense_block_params(gen, cfg)  # weight-tied
        return p

    def input_specs(self, shape: ShapeSpec) -> dict:
        """The batch of one assigned shape cell as meta tensors: tokens
        (audio ``[B, S, K]``) and, for training, labels, int32; the vlm's
        image embeddings in the compute dtype; decode's ``tokens [B]``
        (audio ``[B, K]``) and ``lengths [B]``."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        k = (cfg.num_codebooks,) if cfg.family == "audio" else ()
        if shape.kind in ("train", "prefill"):
            out = {"tokens": meta(b, s, *k)}
            if shape.kind == "train":
                out["labels"] = meta(b, s, *k)
            if cfg.family == "vlm":
                out["image_embeds"] = meta(
                    b, cfg.num_image_tokens, cfg.d_model,
                    dtype=L._dtype(cfg.compute_dtype))
            return out
        return {"tokens": meta(b, *k), "lengths": meta(b)}

    def _cast(self, params):
        """Mixed precision: every fp32 leaf computes in ``compute_dtype``
        (the MoE router, the gate biases and the Mamba2 ``a_log``,
        ``d_skip`` and ``dt_bias`` too, as in the reference).  Pure and
        idempotent, so a caller may cast once and keep the copy
        (``PagedServer`` does); the numbers are those of a cast per call.
        Autograd flows through the cast."""
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
    def _embed(self, p, tokens, positions=None):
        """tokens ``[B, S]`` (audio ``[B, S, K]``: the codebooks' embeddings
        summed in order, plus sinusoidal positions, ``0..S-1`` or the
        decode ``positions [B]``)."""
        cfg = self.cfg
        if cfg.family == "audio":
            x = sum(_lookup(tokens[:, :, i], p["embed"][i])
                    for i in range(cfg.num_codebooks))
            if positions is None:
                pos = torch.arange(x.shape[1], device=x.device)
                x = x + sinusoidal_positions(pos, cfg.d_model, x.dtype)
            else:
                x = x + sinusoidal_positions(positions, cfg.d_model,
                                             x.dtype)[:, None, :]
        else:
            x = _lookup(tokens, p["embed"])
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.d_model)
        return x.to(L._dtype(cfg.compute_dtype))

    def _head_matrix(self, p):
        """``[d, V]``, or audio's ``[K, d, V]``."""
        if self.cfg.tie_embeddings:
            return p["embed"].T
        return p["lm_head"]

    def _logits(self, p, x):
        """fp32 products of the (compute-dtype) head: ``x [..., d]`` ->
        ``[..., V]`` (audio ``[..., K, V]``)."""
        head = self._head_matrix(p).float()
        if self.cfg.family == "audio":
            return torch.einsum("...d,kdv->...kv", x.float(), head)
        return x.float() @ head

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _image(self, batch, dtype):
        return torch.as_tensor(batch["image_embeds"],
                               device=self.device).to(dtype)

    # ------------------------------------------------------------------ #
    # Backbone (full sequence) and loss.
    # ------------------------------------------------------------------ #
    def backbone(self, p, x, batch):
        """Every block over the whole sequence ``x [B, S, d]`` (params
        already cast): ``(final-normed x, aux)``, aux the summed MoE
        load-balance losses (0 without MoE).  With ``remat``, each layer
        (dense, moe, audio) or group (vlm, ssm, hybrid; not the hybrid's
        tail) is recomputed in the backward, at the reference's
        ``jax.checkpoint`` sites."""
        cfg = self.cfg
        f = cfg.family
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), device=x.device)

        def ckpt(fn, *args):
            if self.remat and torch.is_grad_enabled():
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        if f in ("dense", "moe", "audio"):
            for lp in p["layers"]:
                x, ax = ckpt(B.dense_block_train, lp, cfg, x, positions)
                aux = aux + ax
        elif f == "vlm":
            img = self._image(batch, x.dtype)

            def group(selfs, crossp, h, a):
                for lp in selfs:
                    h, ax = B.dense_block_train(lp, cfg, h, positions)
                    a = a + ax
                return B.cross_block_apply(crossp, cfg, h, img), a

            for selfs, crossp in zip(p["self_layers"], p["cross_layers"]):
                x, aux = ckpt(group, selfs, crossp, x, aux)
        elif f == "ssm":
            def group(mls, sls, h):
                for lp in mls:
                    h = B.mlstm_block_train(lp, cfg, h)
                return B.slstm_block_train(sls, cfg, h)

            for mls, sls in zip(p["mlstm"], p["slstm"]):
                x = ckpt(group, mls, sls, x)
        elif f == "hybrid":
            def group(mambas, h, a):
                for lp in mambas:
                    h = B.mamba2_block_train(lp, cfg, h)
                h, ax = B.dense_block_train(p["shared_attn"], cfg, h,
                                            positions)
                return h, a + ax

            for mambas in p["mamba"]:
                x, aux = ckpt(group, mambas, x, aux)
            for lp in p.get("mamba_tail", ()):
                x = B.mamba2_block_train(lp, cfg, x)
        return L.rmsnorm(x, p["final_norm"], cfg.norm_eps), aux

    def loss(self, params, batch, *, vocab_chunk: int = 512):
        """Token cross entropy (labels < 0 masked) plus the MoE aux loss:
        ``(loss, {"xent", "aux"})``.  The logits are computed in fp32 one
        sequence chunk at a time, never ``[B, S, V]`` at once."""
        params = self._cast(params)
        x, aux = self.backbone(
            params, self._embed(params, self._tokens(batch["tokens"])),
            batch)
        labels = self._tokens(batch["labels"])
        s = x.shape[1]
        nchunk = max(1, s // min(vocab_chunk, s))
        cs = s // nchunk
        if s % cs:
            raise ValueError(f"sequence length {s} is not a multiple of its "
                             f"chunk {cs}")
        tot = torch.zeros((), device=x.device)
        cnt = torch.zeros((), device=x.device)
        for i in range(nchunk):
            logits = self._logits(params, x[:, i * cs:(i + 1) * cs])
            ls = labels[:, i * cs:(i + 1) * cs]
            # The gathered target keeps its size-1 dim until the sum: on a
            # DTensor, the gather of vocab-sharded logits is a masked
            # partial whose mask has that shape.
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            tgt = torch.gather(logits, -1, ls.clamp(min=0)[..., None])
            mask = (ls >= 0).float()[..., None]
            tot = tot + torch.sum((lse - tgt) * mask)
            cnt = cnt + torch.sum(mask)
        xent = tot / torch.clamp(cnt, min=1.0)
        return xent + aux, {"xent": xent, "aux": aux}

    # ------------------------------------------------------------------ #
    # Caches, prefill and decode.
    # ------------------------------------------------------------------ #
    def cache_specs(self, batch: int, max_len: int) -> dict:
        """The cache as ``(shape, dtype)`` leaves, laid out as the
        reference's ``cache_specs``."""
        cfg = self.cfg
        f = cfg.family
        dense = B.dense_cache_spec(cfg, batch, max_len)
        if f in ("dense", "moe", "audio"):
            return {"layers": _stack(dense, cfg.num_layers)}
        if f == "vlm":
            img = ((self.n_groups, batch, cfg.num_image_tokens,
                    cfg.num_kv_heads, cfg.resolved_head_dim),
                   L._dtype(cfg.compute_dtype))
            return {"self_layers": _stack(dense, self.n_groups,
                                          self.per_group),
                    "cross_k": img, "cross_v": img}
        if f == "ssm":
            return {"mlstm": _stack(B.mlstm_cache_spec(cfg, batch),
                                    self.n_groups, self.per_group),
                    "slstm": _stack(B.slstm_cache_spec(cfg, batch),
                                    self.n_groups)}
        mamba = B.mamba2_cache_spec(cfg, batch)
        out = {"mamba": _stack(mamba, self.n_groups, self.per_group),
               "attn": _stack(dense, self.n_groups)}
        if self.n_tail:
            out["mamba_tail"] = _stack(mamba, self.n_tail)
        return out

    def init_cache(self, batch: int, max_len: int) -> dict:
        def zeros(node):
            if isinstance(node, dict):
                return {k: zeros(v) for k, v in node.items()}
            shape, dt = node
            return torch.zeros(shape, dtype=dt, device=self.device)

        return zeros(self.cache_specs(batch, max_len))

    @torch.no_grad()
    def prefill(self, params, batch, *, max_len: int | None = None,
                cache=None, spans=None, moe_tally=None):
        """Process the prompt, returning ``(cache, last-position logits)``.

        batch: ``tokens [B, S]`` (audio ``[B, S, K]``), and for the vlm
        ``image_embeds [B, N, d]``.  The cache is laid out as
        ``cache_specs(B, max_len or S)``: ``cache``, zeroed, when given (the
        dry run's sharded cache), else a new one.  MoE layers add to
        ``moe_tally`` (see ``models.moe``).  An MLA model's cache is one
        latent a token and layer (``{"layers": {"latent": [L, B, S, r +
        rope]}}``); its layers record, with a span recorder ``spans``,
        ``prefill.mla`` and then ``prefill.moe`` (``prefill.mlp`` for a dense
        layer) on the host's clock.
        """
        cfg = self.cfg
        f = cfg.family
        params = self._cast(params)
        x = self._embed(params, self._tokens(batch["tokens"]))
        b, s = x.shape[:2]
        ml = max_len or s
        positions = torch.arange(s, device=self.device)
        if cache is None:
            cache = self.init_cache(b, ml)

        def attn(lp, h, node, idx):
            h, k, v = B.dense_block_prefill(lp, cfg, h, positions, ml,
                                            tally=moe_tally)
            _put(node, idx, {"k": k, "v": v})
            return h

        def state(block, lp, h, node, idx):
            h, st = block(lp, cfg, h)
            _put(node, idx, st)
            return h

        if f in ("dense", "moe", "audio") and B._is_mla(cfg):
            for i, lp in enumerate(params["layers"]):
                marks = [clock()] if spans is not None else None
                x, st = B.mla_block_prefill(lp, cfg, x, positions, ml,
                                            tally=moe_tally, marks=marks)
                _put(cache["layers"], i, st)
                if spans is not None:
                    spans.add("prefill.mla", marks[0], marks[1])
                    spans.add("prefill.moe" if "moe" in lp else "prefill.mlp",
                              marks[1], marks[-1])
        elif f in ("dense", "moe", "audio"):
            for i, lp in enumerate(params["layers"]):
                x = attn(lp, x, cache["layers"], i)
        elif f == "vlm":
            img = self._image(batch, x.dtype)
            hd = cfg.resolved_head_dim
            for g, (selfs, crossp) in enumerate(zip(params["self_layers"],
                                                    params["cross_layers"])):
                for i, lp in enumerate(selfs):
                    x = attn(lp, x, cache["self_layers"], (g, i))
                # The cross block's static image K/V (no qk-norm, as in the
                # reference's cache).
                xa = crossp["xattn"]
                kvn = L.rmsnorm(img, xa["kv_norm"], cfg.norm_eps)
                cache["cross_k"][g] = _heads(kvn, xa["wk"],
                                             cfg.num_kv_heads, hd)
                cache["cross_v"][g] = _heads(kvn, xa["wv"],
                                             cfg.num_kv_heads, hd)
                x = B.cross_block_apply(crossp, cfg, x, img)
        elif f == "ssm":
            for g, (mls, sls) in enumerate(zip(params["mlstm"],
                                               params["slstm"])):
                for i, lp in enumerate(mls):
                    x = state(B.mlstm_block_prefill, lp, x, cache["mlstm"],
                              (g, i))
                x = state(B.slstm_block_prefill, sls, x, cache["slstm"], g)
        elif f == "hybrid":
            for g, group in enumerate(params["mamba"]):
                for i, lp in enumerate(group):
                    x = state(B.mamba2_block_prefill, lp, x, cache["mamba"],
                              (g, i))
                x = attn(params["shared_attn"], x, cache["attn"], g)
            for i, lp in enumerate(params.get("mamba_tail", ())):
                x = state(B.mamba2_block_prefill, lp, x, cache["mamba_tail"],
                          i)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return cache, self._logits(params, x[:, -1])

    @torch.no_grad()
    def decode_step(self, params, cache, batch):
        """One token for every sequence.  batch: ``tokens [B]`` (audio ``[B,
        K]``), ``lengths [B]``.  Returns ``(logits [B, V] (audio [B, K, V]),
        cache)``; the cache is updated in place."""
        cfg = self.cfg
        f = cfg.family
        params = self._cast(params)
        tokens = self._tokens(batch["tokens"])
        lengths = self._tokens(batch["lengths"])
        x = self._embed(params, tokens[:, None], positions=lengths)

        def attn(lp, h, node, idx):
            return B.dense_block_decode(lp, cfg, h, _at(node, *idx),
                                        lengths)[0]

        def state(block, lp, h, node, idx):
            h, st = block(lp, cfg, h, _at(node, *idx))
            _put(node, idx, st)
            return h

        if f in ("dense", "moe", "audio") and B._is_mla(cfg):
            for i, lp in enumerate(params["layers"]):
                x = B.mla_block_decode(lp, cfg, x, _at(cache["layers"], i),
                                       lengths)[0]
        elif f in ("dense", "moe", "audio"):
            for i, lp in enumerate(params["layers"]):
                x = attn(lp, x, cache["layers"], (i,))
        elif f == "vlm":
            for g, (selfs, crossp) in enumerate(zip(params["self_layers"],
                                                    params["cross_layers"])):
                for i, lp in enumerate(selfs):
                    x = attn(lp, x, cache["self_layers"], (g, i))
                # Cross attention against the image K/V of prefill.
                hq = L.rmsnorm(x, crossp["norm"], cfg.norm_eps)
                x = x + _cross_decode(crossp["xattn"], cfg, hq,
                                      cache["cross_k"][g],
                                      cache["cross_v"][g])
                x = B._gated_mlp(crossp, cfg, x)
        elif f == "ssm":
            for g, (mls, sls) in enumerate(zip(params["mlstm"],
                                               params["slstm"])):
                for i, lp in enumerate(mls):
                    x = state(B.mlstm_block_decode, lp, x, cache["mlstm"],
                              (g, i))
                x = state(B.slstm_block_decode, sls, x, cache["slstm"], (g,))
        elif f == "hybrid":
            for g, group in enumerate(params["mamba"]):
                for i, lp in enumerate(group):
                    x = state(B.mamba2_block_decode, lp, x, cache["mamba"],
                              (g, i))
                x = attn(params["shared_attn"], x, cache["attn"], (g,))
            for i, lp in enumerate(params.get("mamba_tail", ())):
                x = state(B.mamba2_block_decode, lp, x, cache["mamba_tail"],
                          (i,))
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x)[:, 0], cache


def _heads(x, w, heads: int, hd: int):
    """``x [B, S, d]`` projected to ``[B, S, heads, hd]`` by a 2-D ``[d,
    heads*hd]`` or 3-D ``[d, heads, hd]`` kernel."""
    if w.dim() == 3:
        return torch.einsum("bsd,dhk->bshk", x, w)
    return L._splittable(x @ w, -1, heads).reshape(x.shape[0], x.shape[1],
                                                    heads, hd)


def _cross_decode(p, cfg: ModelConfig, x, ck, cv):
    """Cross attention for decode: x ``[B, 1, d]`` against the image K/V
    ``[B, N, Hkv, hd]`` cached at prefill; q is not qk-normed, as in the
    reference's decode."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q = _heads(x, p["wq"], cfg.num_heads, hd)
    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    qg = L._splittable(q, 2, hkv).reshape(b, 1, hkv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          ck.float()) / math.sqrt(hd)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, cv.float())
    o = o.reshape(b, 1, cfg.num_heads * hd).to(x.dtype)
    out = L._out_proj(p, o)
    return torch.tanh(p["gate"].float()).to(out.dtype) * out
