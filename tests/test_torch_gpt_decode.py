"""The port's KV-cache paths of ``models/gpt.py`` against the JAX package.

Same weights (one flax tree, converted by ``params_from_flax``), same
numpy inputs: prefill, scalar and vector decode steps, offset chunks,
``init_cache``, greedy ``generate``, ``_filter_logits``,
``synthetic_lm_batch``, the int8 helpers of ``ops/quant.py`` and the
quantized logits gate. The tiny f32
configuration is the JAX decode suite's (tests/test_decode_engine.py).

Tolerances: across frameworks, f32 results differ only by summation
order: rtol = atol = 1e-4. The port's chunked prefill against its own
monolithic prefill uses the JAX suite's 1e-5
(tests/test_prefix_cache.py). Tokens and masks are compared exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import gpt as jgpt
from edl_tpu.ops import quant as jquant
from edl_tpu_torch.models import gpt as tgpt
from edl_tpu_torch.ops import quant as tquant

SIZE = dict(num_layers=2, d_model=32, num_heads=2, mlp_dim=64,
            vocab_size=64, max_len=64)
TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jmodel = jgpt.gpt_tiny(dtype=jnp.float32, **SIZE)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = tgpt.gpt_tiny(dtype=torch.float32, device="cpu", **SIZE)
    tmodel.load_state_dict(tgpt.params_from_flax(params))
    return jmodel, params, tmodel


@functools.lru_cache(maxsize=None)
def _jax_cached(jmodel, mode):
    """The JAX model's cache path ``mode`` as one jitted function of
    (params, cache, ids, index) -> (logits, new cache): one compile per
    shape instead of one per primitive."""
    def run(params, cache, ids, index):
        kw = {"prefill": dict(prefill=True),
              "chunk": dict(prefill=True, prefill_offset=index),
              "decode": dict(decode=True, decode_index=index)}[mode]
        logits, muts = jmodel.apply({"params": params, "cache": cache},
                                    ids, mutable=["cache"], **kw)
        return logits, muts["cache"]
    return jax.jit(run)


def _jax_run(jmodel, mode, params, cache, ids, index=0):
    logits, cache = _jax_cached(jmodel, mode)(
        params, cache, jnp.asarray(ids), jnp.asarray(index, jnp.int32))
    return np.asarray(logits), cache


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(
        0, SIZE["vocab_size"], (b, s)).astype(np.int32)


def _flat_cache(tree):
    """JAX's ``muts["cache"]`` keyed as the port keys its cache."""
    return {"%s.attention.%s" % (block, kv): np.asarray(leaf)
            for block, sub in tree.items()
            for kv, leaf in sub["attention"].items()}


def _assert_cache(tcache, jtree):
    want = _flat_cache(jtree)
    assert set(tcache) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(tcache[name].numpy(), w, err_msg=name,
                                   **TOL)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _jax_prefill(jmodel, params, ids):
    cache = jgpt.init_cache(jmodel, params, ids.shape[0])
    return _jax_run(jmodel, "prefill", params, cache, ids)


def _torch_prefill(tmodel, ids):
    cache = tgpt.init_cache(tmodel, None, ids.shape[0])
    with torch.no_grad():
        logits = tmodel(_t(ids), cache=cache, prefill=True)
    return logits.numpy(), cache


def test_init_cache_names_shapes_dtypes(models):
    jmodel, params, tmodel = models
    want = _flat_cache(jgpt.init_cache(jmodel, params, 3))
    got = tgpt.init_cache(tmodel, None, 3)
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape == (3, 64, 2, 16)
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype)
        assert not got[name].any()
    bf = tgpt.Gpt(dtype=torch.bfloat16, device="cpu", **SIZE)
    assert {t.dtype for t in tgpt.init_cache(bf, None, 1).values()} == {
        torch.bfloat16}


@pytest.mark.parametrize("b,s", [(1, 5), (2, 11), (2, 16)])
def test_prefill_logits_and_cache_rows(models, b, s):
    jmodel, params, tmodel = models
    ids = _ids(b, s, seed=s)
    jlogits, jcache = _jax_prefill(jmodel, params, ids)
    tlogits, tcache = _torch_prefill(tmodel, ids)
    np.testing.assert_allclose(tlogits, jlogits, **TOL)
    _assert_cache(tcache, jcache)  # [0, s) written, zeros beyond


@pytest.mark.parametrize("mode", ["scalar", "vector"])
def test_decode_step_logits_and_cache(models, mode):
    """Three decode steps after a prefill: a scalar index (every row at
    the same position, ``generate``'s path) or a [b] vector (each row at
    its own position, the engine's slot layout)."""
    jmodel, params, tmodel = models
    ids = _ids(3, 9, seed=4)
    _, jcache = _jax_prefill(jmodel, params, ids)
    _, tcache = _torch_prefill(tmodel, ids)
    for step in range(3):
        tok = _ids(3, 1, seed=10 + step)
        idx = (9 + step if mode == "scalar"
               else np.array([9 + step, 4 + step, 63], np.int32))
        jlogits, jcache = _jax_run(jmodel, "decode", params, jcache, tok,
                                   idx)
        with torch.no_grad():
            tlogits = tmodel(_t(tok), cache=tcache, decode=True,
                             decode_index=idx)
        np.testing.assert_allclose(tlogits.numpy(), jlogits, **TOL)
        _assert_cache(tcache, jcache)


def _chunks(model_call, prompt, width):
    """Feed ``prompt`` [1, plen] in zero-padded chunks of ``width`` at
    offsets 0, width, ...; returns the last valid position's logits."""
    plen = prompt.shape[1]
    last = None
    for off in range(0, plen, width):
        span = min(width, plen - off)
        ids = np.zeros((1, width), np.int32)
        ids[0, :span] = prompt[0, off:off + span]
        last = model_call(ids, off)[0, span - 1]
    return last


@pytest.mark.parametrize("width", [3, 4, 8])
def test_offset_chunks_match_jax(models, width):
    jmodel, params, tmodel = models
    prompt = _ids(1, 11, seed=7)
    jcache = jgpt.init_cache(jmodel, params, 1)
    tcache = tgpt.init_cache(tmodel, None, 1)

    def jcall(ids, off):
        nonlocal jcache
        logits, jcache = _jax_run(jmodel, "chunk", params, jcache, ids,
                                  off)
        return logits

    def tcall(ids, off):
        with torch.no_grad():
            return tmodel(_t(ids), cache=tcache, prefill=True,
                          prefill_offset=off).numpy()

    np.testing.assert_allclose(_chunks(tcall, prompt, width),
                               _chunks(jcall, prompt, width), **TOL)
    _assert_cache(tcache, jcache)


@pytest.mark.parametrize("width", [2, 4, 5])
def test_offset_chunks_match_monolithic_prefill(models, width):
    _, _, tmodel = models
    prompt = np.array([[5, 3, 8, 1, 9, 2, 7, 4, 6, 1, 2]], np.int32)
    plen = prompt.shape[1]
    full_logits, full_cache = _torch_prefill(tmodel, prompt)
    tcache = tgpt.init_cache(tmodel, None, 1)

    def tcall(ids, off):
        with torch.no_grad():
            return tmodel(_t(ids), cache=tcache, prefill=True,
                          prefill_offset=off).numpy()

    np.testing.assert_allclose(_chunks(tcall, prompt, width),
                               full_logits[0, plen - 1], **SELF_TOL)
    for name, full in full_cache.items():
        np.testing.assert_allclose(tcache[name][:, :plen].numpy(),
                                   full[:, :plen].numpy(), err_msg=name,
                                   **SELF_TOL)


def test_overrun_raises_where_jax_clamps(models):
    """``jax.lax.dynamic_update_slice`` clamps a start that would
    overrun (JAX writes the chunk at max_len - width instead); the port
    refuses it (ROADMAP Queue C)."""
    jmodel, params, tmodel = models
    ids = _ids(1, 4, seed=1)
    jcache = jgpt.init_cache(jmodel, params, 1)
    _, jcache = _jax_run(jmodel, "chunk", params, jcache, ids, 62)
    # the chunk landed clamped, at [60, 64)
    assert np.asarray(jcache["block_0"]["attention"]["k"])[0, 60].any()
    tcache = tgpt.init_cache(tmodel, None, 1)
    with torch.no_grad(), pytest.raises(ValueError, match="overruns"):
        tmodel(_t(ids), cache=tcache, prefill=True, prefill_offset=62)
    with torch.no_grad(), pytest.raises(ValueError, match="overruns"):
        tmodel(_t(ids[:, :1]), cache=tcache, decode=True, decode_index=64)
    with torch.no_grad(), pytest.raises(ValueError, match="overruns"):
        tmodel(_t(_ids(2, 1, 0)), cache=tgpt.init_cache(tmodel, None, 2),
               decode=True, decode_index=np.array([3, -1]))
    with pytest.raises(ValueError, match="need a cache"):
        tmodel(_t(ids), prefill=True)


# prompts by length, as the JAX suite batches generate: one call per
# length on each side
_PROMPTS = {3: [[1, 5, 9], [3, 3, 3], [9, 8, 7]],
            4: [[2, 4, 6, 8], [7, 1, 7, 1]],
            11: [[5, 3, 8, 1, 9, 2, 7, 4, 6, 1, 2]]}


@pytest.mark.parametrize("plen", sorted(_PROMPTS))
def test_generate_greedy_tokens_identical(models, plen):
    jmodel, params, tmodel = models
    prompts = np.asarray(_PROMPTS[plen], np.int32)
    want = np.asarray(jax.jit(lambda p, ids: jgpt.generate(
        jmodel, p, ids, 12))(params, prompts))
    got = tgpt.generate(tmodel, None, prompts, 12)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's state-dict form of the same weights
    state = {k: v.detach() for k, v in tmodel.state_dict().items()}
    np.testing.assert_array_equal(
        tgpt.generate(tmodel, state, prompts, 12).numpy(), want)


def test_generate_edges(models):
    _, _, tmodel = models
    ids = np.array([[1, 2, 3]], np.int32)
    assert tgpt.generate(tmodel, None, ids, 0).tolist() == [[1, 2, 3]]
    assert tgpt.generate(tmodel, None, ids, 1).shape == (1, 4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tgpt.generate(tmodel, None, ids, 62)


def test_sampling_top1_equals_greedy(models):
    """torch.Generator does not give jax.random's bits, so sampled
    tokens are not compared across frameworks; temperature > 0 with
    top_k=1 must be greedy whatever the bits."""
    _, _, tmodel = models
    ids = np.array([[1, 5, 9], [2, 4, 6]], np.int32)
    greedy = tgpt.generate(tmodel, None, ids, 8)
    gen = torch.Generator().manual_seed(3)
    top1 = tgpt.generate(tmodel, None, ids, 8, generator=gen,
                         temperature=0.7, top_k=1)
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    sampled = tgpt.generate(tmodel, None, ids, 8, generator=gen,
                            temperature=1.0, top_k=5, top_p=0.9)
    assert sampled.shape == (2, 11)
    assert ((sampled >= 0) & (sampled < SIZE["vocab_size"])).all()


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (1, 0.0), (2, 0.0),
                                         (5, 0.0), (0, 0.6), (0, 1e-6),
                                         (0, 0.95), (3, 0.5), (64, 0.9),
                                         (100, 0.0)])
def test_filter_logits_masks_equal(top_k, top_p):
    rng = np.random.RandomState(top_k * 100 + int(top_p * 100))
    logits = rng.randn(3, 64).astype(np.float32) * 2.0
    logits[1, 7] = logits[1, 9]  # a tie
    want = np.asarray(jgpt._filter_logits(jnp.asarray(logits), top_k=top_k,
                                          top_p=top_p))
    got = tgpt._filter_logits(torch.from_numpy(logits), top_k=top_k,
                              top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_lm_batch_equals_jax(seed):
    got = tgpt.synthetic_lm_batch(5, seq_len=24, vocab_size=64, seed=seed)
    want = jgpt.synthetic_lm_batch(5, seq_len=24, vocab_size=64, seed=seed)
    assert got["input_ids"].dtype == want["input_ids"].dtype
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])


def test_int8_matmul_and_quantized_bytes(models):
    _, params, tmodel = models
    rng = np.random.RandomState(0)
    w = rng.randn(32, 48).astype(np.float32)
    x = rng.randn(5, 32).astype(np.float32)
    jq, jscale = jquant.absmax_quantize(w)
    tq, tscale = tquant.absmax_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, jscale))
    got = tquant.int8_matmul(torch.from_numpy(x), tq, tscale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    state = {k: v.detach() for k, v in tmodel.state_dict().items()}
    for mode in ("int8", "bf16"):
        assert tquant.quantized_bytes(tquant.quantize_tree(state, mode)) \
            == jquant.quantized_bytes(jquant.quantize_tree(params, mode))
    assert tquant.quantized_bytes(state) == jquant.quantized_bytes(params)


@pytest.mark.parametrize("mode,max_rel", [("int8", 0.05), ("bf16", 0.05)])
def test_quantized_logits_gate(models, mode, max_rel):
    """The JAX suite's gate on the port's quantized forward — within
    rel-Frobenius 0.05 of f32 and >= 90% top-1 agreement — and the
    port's quantized logits against JAX's quantized logits."""
    jmodel, params, tmodel = models
    ids = np.arange(24, dtype=np.int32).reshape(2, 12) % 64
    state = {k: v.detach() for k, v in tmodel.state_dict().items()}
    qstate = tquant.quantize_tree(state, mode)
    with torch.no_grad():
        ref = tmodel(_t(ids)).numpy()
        got = tgpt.apply(tmodel, qstate, _t(ids)).numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < max_rel, "rel fro err %.4f" % rel
    assert np.mean(got.argmax(-1) == ref.argmax(-1)) >= 0.9
    qparams = jquant.quantize_tree(params, mode)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": jquant.dequantize_tree(p)}, x))(qparams,
                                                    jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, **TOL)
