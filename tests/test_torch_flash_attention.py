"""Parity of the port's flash attention and attention dispatch with the
JAX package's, on the CPU.

On a CPU tensor the port's ``flash_attention`` runs its plain version
(the loop over kv blocks that ``chip_smoke.py`` holds the CUDA kernel
against on the card); the JAX side runs its Pallas kernel in interpret
mode and its ``_blockwise_reference``. Inputs come from numpy with a
seed. Tolerance 2e-5 in f32, the JAX suite's own
(tests/test_flash_attention.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import attention as jattn
from edl_tpu.ops import flash_attention as jfa
from edl_tpu_torch.ops import attention as tattn
from edl_tpu_torch.ops import flash_attention as tfa

F32_TOL = 2e-5


def _qkv(b=2, h=2, s=64, sk=None, d=16, seed=0):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    mk = lambda n: (rng.randn(b, h, n, d) * 0.4).astype(np.float32)
    return mk(s), mk(sk), mk(sk)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,sk", [(64, 64), (96, 96), (64, 96), (96, 80)])
def test_plain_flash_matches_jax_kernel_and_reference(causal, s, sk):
    """s=96 with 32-row blocks is a ragged q tail; sk != s exercises the
    diagonal anchored at position 0; sk=80 is ragged kv (the JAX
    streaming kernel's regime)."""
    q, k, v = _qkv(s=s, sk=sk)
    scale = q.shape[-1] ** -0.5
    got = tfa.flash_attention(*_torch(q, k, v), causal).numpy()
    ref = jfa._blockwise_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, scale, block_k=32)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)
    if sk % 32:
        # the JAX streaming kernel reads the out-of-range tail of the last
        # V block unmasked into p.v, so its interpret-mode output is NaN
        # on every row that reaches that block (ROADMAP.md, Queue C); the
        # port zero-fills the tail and is held to the reference above
        return
    kernel = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, None, 32, 32, True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=F32_TOL,
                               atol=F32_TOL)


def test_mha_layout_matches_jax():
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in _qkv(s=48))
    got = tfa.mha(*_torch(q, k, v), causal=True).numpy()
    want = jfa.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_refuses_gradient_and_bad_shapes():
    """A gradient is asked for: the call goes through the autograd
    function (the backward is ported); without one it builds no graph.
    Bad shapes are still refused."""
    q, k, v = _torch(*_qkv(s=32))
    q.requires_grad_(True)
    out = tfa.flash_attention(q, k, v, True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v, True).grad_fn is None
    with pytest.raises(ValueError, match="shape mismatch"):
        tfa.flash_attention(k, k[:, :1], v, False)


@pytest.mark.parametrize("bad,err,match", [
    ("dtype", TypeError, "float32 or bfloat16"),
    ("head_dim", ValueError, "multiple of 8"),
    ("wide", ValueError, "up to 256"),
    ("strided", ValueError, "contiguous"),
])
def test_kernel_wrapper_checks_before_launch(bad, err, match):
    """The CUDA wrapper's checks run before the kernel library is even
    loaded, so they are testable here on CPU tensors."""
    d = {"head_dim": 12, "wide": 264}.get(bad, 16)
    q, k, v = _torch(*_qkv(s=32, d=d))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    if bad == "strided":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(err, match=match):
        tfa._launch(q, k, v, True, d ** -0.5)


@pytest.mark.parametrize("use_flash", [True, False, None])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_context_matches_jax(use_flash, causal):
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in _qkv(s=64))
    got = tattn.attention_context(*_torch(q, k, v), causal=causal,
                                  mask=None, dtype=torch.float32,
                                  use_flash=use_flash).numpy()
    want = jattn.attention_context(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, mask=None,
                                   dtype=jnp.float32, use_flash=use_flash)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_attention_context_dense_mask_and_bf16_match_jax():
    """The dense path's key mask, and bf16 inputs (q * scale rounds in
    bf16 before the f32 upcast on both sides): bf16 output agrees to
    one bf16 ulp at |x| < 1 (2**-8)."""
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in _qkv(s=32))
    mask = np.random.RandomState(1).rand(2, 32) > 0.3
    mask[:, 0] = True
    got = tattn.attention_context(*_torch(q, k, v), causal=True,
                                  mask=torch.from_numpy(mask),
                                  dtype=torch.float32, use_flash=None)
    want = jattn.attention_context(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   mask=jnp.asarray(mask),
                                   dtype=jnp.float32, use_flash=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    tq, tk, tv = (t.bfloat16() for t in _torch(q, k, v))
    got = tattn.attention_context(tq, tk, tv, causal=True, mask=None,
                                  dtype=torch.bfloat16, use_flash=False)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jattn.attention_context(jq, jk, jv, causal=True, mask=None,
                                   dtype=jnp.bfloat16, use_flash=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2.0 ** -8)


@pytest.mark.parametrize("case", [
    dict(),
    dict(mask=np.ones((1, 256), bool)),
    dict(offset=4),
    dict(seq_kv=512),
    dict(head_dim=60),
    dict(seq_len=200),
    dict(seq_len=96),
    dict(env="0"),
])
def test_dispatch_refusals_match_jax(case, monkeypatch):
    """Every refusal of the JAX dispatch holds in the port, with a CUDA
    device in the role of the TPU platform; the CPU always refuses."""
    case = dict(case)
    if case.pop("env", None):
        monkeypatch.setenv("EDL_TPU_FLASH_AUTO", "0")
    seq_len = case.pop("seq_len", 256)
    head_dim = case.pop("head_dim", 64)
    want = jattn.flash_dispatch_reason(seq_len, head_dim, platform="tpu",
                                       **case)
    got = tattn.flash_dispatch_reason(seq_len, head_dim, device="cuda",
                                      **case)
    assert (got is None) == (want is None), (got, want)
    if want is not None:
        assert got == want
    assert tattn.flash_dispatch_reason(seq_len, head_dim, device="cpu",
                                       **case) is not None


def test_dispatch_refuses_head_dim_above_kernel():
    assert "above the kernel" in tattn.flash_dispatch_reason(
        256, 264, device="cuda")
