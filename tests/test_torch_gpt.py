"""Parity of the port's ``Gpt`` forward with the JAX package's, on the
CPU: one flax param tree, converted by ``params_from_flax``, runs through
both. With ``use_flash=True`` the JAX side runs its Pallas kernel in
interpret mode and the port the kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import gpt as jgpt
from edl_tpu_torch.models import gpt as tgpt

from _torch_threads import _one_torch_thread  # noqa: F401


KW = dict(num_layers=2, d_model=64, num_heads=4, mlp_dim=128,
          vocab_size=128, max_len=64)
# f32 through the whole stack: the JAX suite's own dense-vs-flash gate
# (tests/test_attention_dispatch.py)
F32_TOL = 2e-4
# bf16 activations round at different points in XLA and in torch (matmul
# accumulation, GELU, the residual adds); the f32 logits then differ by
# about one bf16 ulp at their own magnitude. Allowed: two bf16 ulps at
# |logits| < 8, i.e. 2 * 2**-5 (the test checks the magnitude).
BF16_TOL = 2 * 2.0 ** -5


@pytest.fixture(scope="module")
def flax_params():
    ids = jnp.zeros((1, 8), jnp.int32)
    return jgpt.Gpt(**KW, dtype=jnp.float32, use_flash=False).init(
        jax.random.PRNGKey(0), ids)["params"]


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, 128, (2, 64)).astype(
        np.int32)


def _both(params, jdtype, tdtype, use_flash, ids):
    want = jgpt.Gpt(**KW, dtype=jdtype, use_flash=use_flash).apply(
        {"params": params}, jnp.asarray(ids))
    model = tgpt.Gpt(**KW, dtype=tdtype, use_flash=use_flash, device="cpu")
    model.load_state_dict(tgpt.params_from_flax(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids.astype(np.int64)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("use_flash", [True, False])
def test_gpt_f32_matches_jax(flax_params, use_flash):
    got, want = _both(flax_params, jnp.float32, torch.float32, use_flash,
                      _ids())
    assert got.dtype == np.float32 and got.shape == (2, 64, 128)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("use_flash", [None, True])
def test_gpt_bf16_as_teacher_builds_it_matches_jax(flax_params, use_flash):
    got, want = _both(flax_params, jnp.bfloat16, torch.bfloat16, use_flash,
                      _ids(1))
    assert got.dtype == np.float32  # the tied head runs in f32
    assert np.abs(want).max() < 8.0
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


def test_params_from_flax_names_and_layouts(flax_params):
    state = tgpt.params_from_flax(flax_params)
    model = tgpt.Gpt(**KW, dtype=torch.float32, device="cpu")
    assert set(state) == set(model.state_dict())
    # DenseGeneral layouts kept as flax has them
    assert state["block_0.attention.query.kernel"].shape == (64, 4, 16)
    assert state["block_0.attention.out.kernel"].shape == (4, 16, 64)
    assert state["block_1.mlp_up.kernel"].shape == (64, 128)
    np.testing.assert_array_equal(
        state["word_embed.embedding"].numpy(),
        np.asarray(flax_params["word_embed"]["embedding"]))


def test_gpt_init_weights_is_seeded():
    make = lambda seed: tgpt.Gpt(**KW, device="cpu").init_weights(
        torch.Generator().manual_seed(seed)).state_dict()
    a, b, c = make(3), make(3), make(4)
    for name in a:
        assert torch.equal(a[name], b[name])
    assert not torch.equal(a["block_0.mlp_up.kernel"],
                           c["block_0.mlp_up.kernel"])


def test_gpt_rejects_sequence_beyond_max_len():
    model = tgpt.Gpt(**KW, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="exceeds max_len"):
        model(torch.zeros((1, 65), dtype=torch.long))
