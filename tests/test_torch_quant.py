"""Parity of the port's weight quantization with the JAX package's: the
same flax param tree quantized on both sides gives the same int8 values
and scales, and dequantizes to the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import gpt as jgpt
from edl_tpu.ops import quant as jquant
from edl_tpu_torch.models import gpt as tgpt
from edl_tpu_torch.ops import quant as tquant

from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def flax_params():
    model = jgpt.Gpt(num_layers=1, d_model=32, num_heads=2, mlp_dim=64,
                     vocab_size=64, max_len=16, dtype=jnp.float32)
    return model.init(jax.random.PRNGKey(1),
                      jnp.zeros((1, 4), jnp.int32))["params"]


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jquant.QTensor))[0]:
        out[".".join(p.key for p in path)] = leaf
    return out


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantize_tree_matches_jax(flax_params, mode):
    want = _flat(jquant.quantize_tree(flax_params, mode))
    got = tquant.quantize_tree(tgpt.params_from_flax(flax_params), mode)
    assert set(got) == set(want)
    for name, leaf in got.items():
        ref = want[name]
        if isinstance(ref, jquant.QTensor):
            assert isinstance(leaf, tquant.QTensor), name
            np.testing.assert_array_equal(leaf.values.numpy(),
                                          np.asarray(ref.values))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(ref.scale))
        else:
            np.testing.assert_array_equal(
                leaf.float().numpy(), np.asarray(ref, np.float32))
            assert (leaf.dtype == torch.bfloat16) == (
                ref.dtype == jnp.bfloat16), name
    back = tquant.dequantize_tree(got)
    ref_back = _flat(jquant.dequantize_tree(jquant.quantize_tree(
        flax_params, mode)))
    for name, leaf in back.items():
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(ref_back[name]))


def test_quantize_tree_rejects_unknown_mode():
    with pytest.raises(ValueError, match="int8|bf16"):
        tquant.quantize_tree({}, "fp4")
