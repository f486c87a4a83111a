"""Random weights of a dense decoder, made on the device from the seed.

A few large draws (one per kind of matrix, stacked over the layers) from
a ``torch.Generator`` on the device, in the dtype they are served in;
each layer's matrices are views of the stacks.  The tree is laid out as
the port's ``LM`` takes it (``[in, out]`` projections, a list of layers,
norms stored as offsets from one); the plain reference reads the same
tree.  Projections are N(0, 1/in), the embedding N(0, 0.02^2) and the
norm offsets N(0, 0.1^2), so that every norm weight differs from one.
"""

from __future__ import annotations

import math


def make(cfg: dict, seed: int, device, dtype) -> dict:
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed))
    n = cfg["num_hidden_layers"]
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    ff = cfg["intermediate_size"]
    v = cfg["vocab_size"]

    def draw(shape, std):
        w = torch.empty(shape, dtype=dtype, device=device)
        return w.normal_(0.0, std, generator=g)

    mats = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
            "wo": (h * hd, d), "w_gate": (d, ff), "w_up": (d, ff),
            "w_down": (ff, d)}
    stacks = {k: draw((n, *s), 1.0 / math.sqrt(s[0])) for k, s in mats.items()}
    norms = draw((n, 2, d), 0.1)
    qk = draw((n, 2, hd), 0.1)
    tree = {"embed": draw((v, d), 0.02), "final_norm": draw((d,), 0.1)}
    if not cfg["tie_word_embeddings"]:
        tree["lm_head"] = draw((d, v), 1.0 / math.sqrt(d))
    tree["layers"] = [
        {"attn_norm": norms[i, 0], "mlp_norm": norms[i, 1],
         "attn": {"wq": stacks["wq"][i], "wk": stacks["wk"][i],
                  "wv": stacks["wv"][i], "wo": stacks["wo"][i],
                  "q_norm": qk[i, 0], "k_norm": qk[i, 1]},
         "mlp": {"w_gate": stacks["w_gate"][i], "w_up": stacks["w_up"][i],
                 "w_down": stacks["w_down"][i]}}
        for i in range(n)]
    return tree
