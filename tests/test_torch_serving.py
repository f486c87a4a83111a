"""repro_torch's PagedServer on the CPU: the serving contracts, and the JAX server.

First the five contracts of ``tests/test_serving.py`` on the port's
``PagedServer(device="cpu")`` (paged logits == dense-cache logits at 2e-3,
prefix hits, copy-on-write, pages freed, foreign-PDID protection fault).
Then one whole ``run_until_done`` with prefix sharing and a copy-on-write,
on the port and on the JAX ``PagedServer`` with the same parameters
(``lm_params_from_numpy``) and prompts: in fp32 every request's tokens, the
stats dict and ``directory_entries`` are identical; in bf16 the stats are
identical (paging depends only on prompts and lengths) and the first decode
step's logits agree within 0.1 — bf16 keeps 8 bits of mantissa, and the two
frameworks round bf16 products at different places, so two rounding steps
per layer move logits of order one by a few 1e-2.  bf16 tokens need not
match.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models.model import LM as JLM
from repro.serving.engine import PagedServer as JServer

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.types import AccessType, MemAccess
from repro_torch.models.model import LM
from repro_torch.serving.engine import PagedServer


@pytest.fixture(scope="module")
def served():
    cfg = dataclasses.replace(t_reduced_config(t_get_config("qwen3-4b")),
                              compute_dtype="float32")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def server(model, params, **kw):
    return PagedServer(model, params, device="cpu", **kw)


# --------------------------------------------------------------------- #
# The five contracts of tests/test_serving.py.
# --------------------------------------------------------------------- #
def test_paged_decode_matches_dense_decode(served):
    cfg, model, params = served
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)

    cache, logits_pre = model.prefill(params, {"tokens": prompt[None]},
                                      max_len=32)
    tok0 = int(np.argmax(logits_pre[0].numpy()))
    ref_logits, _ = model.decode_step(
        params, cache, {"tokens": torch.tensor([tok0]),
                        "lengths": torch.tensor([len(prompt)])})

    srv = server(model, params, page_tokens=8, num_pages=64,
                 prefix_share=False)
    srv.submit(prompt, max_new_tokens=8)
    req = srv.queue.pop(0)
    srv._prefill(req)
    srv.active.append(req)
    assert req.generated[0] == tok0  # prefill paths agree on the argmax
    bt = np.zeros((1, 8), np.int32)
    bt[0, : len(req.pages) + 1] = req.pages + [
        srv.pool.alloc_page(req.session)]
    got_logits, srv.pool.k_pool, srv.pool.v_pool = srv._decode_fn(
        srv.params, srv.pool.k_pool, srv.pool.v_pool,
        torch.tensor([tok0], dtype=torch.int32),
        torch.tensor([len(prompt)], dtype=torch.int32), torch.from_numpy(bt))
    np.testing.assert_allclose(got_logits.numpy(), ref_logits.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_prefix_sharing_hits(served):
    cfg, model, params = served
    rng = np.random.default_rng(1)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)  # 2 pages
    srv = server(model, params, page_tokens=8, num_pages=64)
    for i in range(3):
        srv.submit(np.concatenate([shared, [i]]), max_new_tokens=3)
    stats = srv.run_until_done()
    assert stats["prefix_hits"] >= 4  # 2 pages x 2 subsequent requests
    assert stats["alloc"] < 9


def test_copy_on_write_on_shared_page_append(served):
    cfg, model, params = served
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)  # 1.5 pages
    srv = server(model, params, page_tokens=8, num_pages=64)
    srv.submit(prompt.copy(), max_new_tokens=3)
    srv.submit(prompt.copy(), max_new_tokens=3)  # shares the partial tail
    stats = srv.run_until_done()
    assert stats["prefix_hits"] >= 2
    assert stats["cow"] >= 1


def test_pool_pages_freed_after_completion(served):
    cfg, model, params = served
    rng = np.random.default_rng(3)
    srv = server(model, params, page_tokens=8, num_pages=64)
    for _ in range(3):
        srv.submit(rng.integers(0, cfg.vocab_size, 10), max_new_tokens=2)
    srv.run_until_done()
    assert srv.pool.pages_in_use == 0


def test_session_isolation_protection(served):
    cfg, model, params = served
    rng = np.random.default_rng(4)
    srv = server(model, params, page_tokens=8, num_pages=64,
                 prefix_share=False)
    srv.submit(rng.integers(0, cfg.vocab_size, 9), max_new_tokens=6,
               session=101)
    srv.step()  # prefill allocates pages for session 101
    ref = srv.pool._pages[srv.active[0].pages[0]]
    res = srv.pool.mmu.handle(MemAccess(0, 999, ref.vaddr, AccessType.READ))
    assert res.acts.fault == "protection"
    srv.run_until_done()


def test_server_refuses_a_model_on_another_device(served):
    _, model, params = served
    with pytest.raises(ValueError, match="model is on"):
        PagedServer(model, params, device="meta")


# --------------------------------------------------------------------- #
# A whole run against the JAX PagedServer.
# --------------------------------------------------------------------- #
def _prompts(vocab):
    """Five prompts: a 16-token (two-page) shared prefix with distinct
    tails, two of them identical, so their partial tail page is shared and
    the first decode append into it copies on write."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, 16)
    tails = [rng.integers(0, vocab, n) for n in (5, 3, 9, 5)]
    tails.insert(1, tails[0])
    return [np.concatenate([shared, tl]).astype(np.int32) for tl in tails]


def _run(srv, prompts, first_logits):
    """``run_until_done`` recording the first decode step's logits."""
    inner = srv._decode_fn

    def decode(*args):
        out = inner(*args)
        if not first_logits:
            first_logits.append(np.asarray(out[0], np.float32))
        return out

    srv._decode_fn = decode
    for p in prompts:
        srv.submit(p, max_new_tokens=5)
    stats = srv.run_until_done()
    return stats, {r.rid: r.generated for r in srv.finished}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def both(request):
    """The same run on both servers: (stats, tokens, first logits) each."""
    jcfg, tcfg = (dataclasses.replace(red(get("qwen3-4b")),
                                      compute_dtype=request.param,
                                      num_kv_heads=2)
                  for red, get in ((reduced_config, get_config),
                                   (t_reduced_config, t_get_config)))
    jm = JLM(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = LM(tcfg, device="cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    prompts = _prompts(tcfg.vocab_size)
    kw = dict(max_batch=3, page_tokens=8, num_pages=64)
    jlog, tlog = [], []
    jres = _run(JServer(jm, jp, **kw), prompts, jlog)
    tres = _run(PagedServer(tm, tp, device="cpu", **kw), prompts, tlog)
    return request.param, jres, tres, jlog[0], tlog[0]


def test_run_until_done_stats_match_jax(both):
    _, (jstats, _), (tstats, _), _, _ = both
    assert tstats == jstats
    assert tstats["prefix_hits"] > 0 and tstats["cow"] >= 1
    assert tstats["directory_entries"] == jstats["directory_entries"]


def test_run_until_done_tokens_and_logits_match_jax(both):
    dtype, (_, jtok), (_, ttok), jlog, tlog = both
    assert sorted(ttok) == sorted(jtok) == list(range(5))
    if dtype == "float32":
        assert ttok == jtok
        np.testing.assert_allclose(tlog, jlog, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(tlog, jlog, rtol=0.1, atol=0.1)
