"""Parity of the port's flash-attention gradient with the JAX package's,
on the CPU.

On CPU tensors the port's autograd function runs the plain backward
(``flash_bwd_reference``, the port of ``_flash_bwd`` that
``chip_smoke.py`` holds the CUDA backward kernels against on the card),
given the lse that the plain forward returned, as the kernels take it
from the forward kernel: nothing recomputes the softmax statistics.
Inputs come from numpy with a seed. Tolerances: 1e-4 on gradients in
f32, the JAX suite's (tests/test_flash_attention.py); 1e-5 against
torch autograd through the port's own differentiable plain forward
(both sides sum f32 products of the same blocks, in other orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.ops import flash_attention as jfa
from edl_tpu_torch.ops import flash_attention as tfa

from _torch_threads import _one_torch_thread  # noqa: F401


GRAD_TOL = 1e-4
AUTOGRAD_TOL = 1e-5


def _inputs(b=1, h=2, s=64, sk=None, d=16, seed=0, scale=0.4):
    """q, k, v, g as numpy f32: [b, h, s, d] and [b, h, sk, d]."""
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    mk = lambda n, std: (rng.randn(b, h, n, d) * std).astype(np.float32)
    return mk(s, scale), mk(sk, scale), mk(sk, scale), mk(s, 1.0)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [(64, 64, True), (64, 64, False), (40, 96, True), (96, 40, True),
         (40, 96, False), (48, 80, True)]


@functools.lru_cache(maxsize=None)
def _jax_flash_bwd(s, sk, causal):
    """JAX's forward output and ``_flash_bwd`` gradients at ``_inputs``'
    shape (computed once for both parametrisations of the test below)."""
    q, k, v, g = _inputs(s=s, sk=sk)
    scale = q.shape[-1] ** -0.5
    out = jfa._blockwise_reference(*map(jnp.asarray, (q, k, v)), causal,
                                   scale, block_k=32)
    want = jfa._flash_bwd(*map(jnp.asarray, (q, k, v)), out, jnp.asarray(g),
                          causal, scale, block_k=32)
    return np.array(out), [np.asarray(x) for x in want]


@pytest.mark.parametrize("lse_from", [None, "forward"],
                         ids=["pass1", "fwd_lse"])
@pytest.mark.parametrize("s,sk,causal", CASES,
                         ids=["s%dsk%d%s" % (s, sk, "c" if c else "f")
                              for s, sk, c in CASES])
def test_plain_backward_matches_jax_flash_bwd(s, sk, causal, lse_from):
    """s != sk anchors the causal diagonal at 0 (s < sk leaves kv rows
    no query reaches: their dk, dv are 0); sk = 80 with 32-row blocks is
    a ragged kv tail. ``lse_from``: None recomputes the row statistics
    (the step-by-step port of ``_flash_bwd``'s pass 1); "forward" takes
    the lse that ``blockwise_reference`` returns, as the kernels do."""
    q, k, v, g = _inputs(s=s, sk=sk)
    scale = q.shape[-1] ** -0.5
    out, want = _jax_flash_bwd(s, sk, causal)
    lse = None
    if lse_from == "forward":
        lse = tfa.blockwise_reference(*_torch(q, k, v), causal, scale,
                                      block_k=32, return_lse=True)[1]
    got = tfa.flash_bwd_reference(*_torch(q, k, v, out, g), causal, scale,
                                  block_k=32, lse=lse)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg="d" + name)
    if causal and s < sk:
        assert not got[1][:, :, s:].any() and not got[2][:, :, s:].any()


@functools.lru_cache(maxsize=None)
def _jax_grad_of_the_interpreted_kernel():
    q, k, v, _ = _inputs(b=2, s=48, d=8)

    def loss_jax(q, k, v):
        return (jfa.flash_attention(q, k, v, True, None, 16, 16, True)
                ** 2).sum()

    return [np.asarray(x) for x in jax.grad(loss_jax, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


@pytest.mark.parametrize("row_stats", ["allowed", "raises"])
def test_autograd_matches_jax_grad_of_the_interpreted_kernel(monkeypatch,
                                                             row_stats):
    """The reference suite's shape (tests/test_flash_attention.py:47):
    s=48, d=8, causal, the loss sum(out**2); JAX differentiates its
    Pallas kernel in interpret mode through its custom_vjp. With
    ``_row_stats`` made to raise, the same gradients come: the backward
    takes the forward's lse and recomputes no statistics."""
    if row_stats == "raises":
        def recompute(*args):
            raise AssertionError("the backward recomputed the row stats")
        monkeypatch.setattr(tfa, "_row_stats", recompute)
    q, k, v, _ = _inputs(b=2, s=48, d=8)
    want = _jax_grad_of_the_interpreted_kernel()
    tq, tk, tv = (t.requires_grad_(True) for t in _torch(q, k, v))
    loss = (tfa.flash_attention(tq, tk, tv, True) ** 2).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("s,sk,causal", [(64, 64, True), (40, 96, False),
                                         (96, 40, True)])
def test_function_gradient_matches_autograd_of_plain_forward(s, sk, causal):
    """The autograd function's CPU backward against torch autograd
    through ``blockwise_reference``, which is differentiable. Both are
    f32, so a float64 ``gradcheck`` does not apply."""
    q, k, v, g = _torch(*_inputs(s=s, sk=sk, scale=1.0))
    scale = q.shape[-1] ** -0.5
    grads = []
    for fn in (lambda *a: tfa.flash_attention(*a, causal, scale),
               lambda *a: tfa.blockwise_reference(*a, causal, scale, 32)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=AUTOGRAD_TOL,
                                   atol=AUTOGRAD_TOL)


def test_bf16_inputs_give_bf16_grads():
    """bf16 in, bf16 gradients out, computed in f32 from the same bf16
    values: the bf16 path is the f32 one rounded at the end (the f32 one
    given the lse of the f32 forward on the same values)."""
    q, k, v, g = _torch(*_inputs(s=64))
    b16 = [t.bfloat16() for t in (q, k, v, g)]
    leaves = [t.clone().requires_grad_(True) for t in b16[:3]]
    out = tfa.flash_attention(*leaves, True)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, leaves, b16[3])
    f32 = [t.float() for t in b16[:3]]
    lse = tfa.blockwise_reference(*f32, True, 0.25, return_lse=True)[1]
    want = tfa.flash_bwd_reference(*f32, out.detach().float(),
                                   b16[3].float(), True, 0.25, lse=lse)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b.bfloat16(), rtol=0, atol=0)


LSE_CASES = [(64, 64, True), (64, 64, False), (50, 50, True),
             (40, 96, True), (96, 40, False), (64, 8, False)]


@pytest.mark.parametrize("s,sk,causal", LSE_CASES,
                         ids=["s%dsk%d%s" % (s, sk, "c" if c else "f")
                              for s, sk, c in LSE_CASES])
def test_plain_forward_lse_matches_pass_one(s, sk, causal):
    """The lse that ``blockwise_reference`` returns beside its output is
    the JAX backward's pass 1 (``flash_bwd_stats_reference``) within
    1e-6: causal, full, ragged (50 over 32-row blocks), s != sk both
    ways and a short kv (8 keys in one block)."""
    q, k, v, g = _torch(*_inputs(s=s, sk=sk, scale=1.0))
    scale = q.shape[-1] ** -0.5
    out, lse = tfa.blockwise_reference(q, k, v, causal, scale, block_k=32,
                                       return_lse=True)
    assert torch.equal(out, tfa.blockwise_reference(q, k, v, causal, scale,
                                                    block_k=32))
    want = tfa.flash_bwd_stats_reference(q, k, out, g, causal, scale,
                                         block_k=32)[0]
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-6)


def test_stats_reference_is_pass_one():
    """The stats kernel's plain version: lse of the masked scores and
    delta = rowsum(g * out), against the dense softmax's log-sum-exp."""
    q, k, v, g = _torch(*_inputs(s=40, sk=96))
    scale = 0.25
    out = tfa.blockwise_reference(q, k, v, True, scale)
    lse, delta = tfa.flash_bwd_stats_reference(q, k, out, g, True, scale,
                                               block_k=32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    tri = torch.ones(40, 96, dtype=torch.bool).tril()
    want = torch.logsumexp(scores.masked_fill(~tri, -torch.inf), -1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(delta, (g * out).sum(-1))


def test_no_graph_under_inference_mode():
    q, k, v, _ = _torch(*_inputs(s=32))
    q.requires_grad_(True)
    with torch.inference_mode():
        out = tfa.flash_attention(q, k, v, True)
    assert out.grad_fn is None and not out.requires_grad


def test_cuda_backward_checks_before_any_library_loads(monkeypatch):
    """The backward's wrappers run the forward's checks first; on a
    shape the kernels do not take they raise before nvcc is asked."""
    loads = []
    monkeypatch.setattr(tfa, "_kernel_lib", loads.append)
    lse = torch.zeros((1, 1, 8))
    q = torch.zeros((1, 1, 8, 12))
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_bwd(q, q, q, q, q, lse, True, 12 ** -0.5)
    q = torch.zeros((1, 1, 8, 16), dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_bwd(q, q, q, q, q, lse, True, 0.25)
    q = torch.zeros((1, 1, 16, 8)).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_bwd(q, q, q, q, q, lse, True, 0.25)
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="no lse from the forward"):
        tfa.flash_bwd(q, q, q, q, q, None, True, 0.25)
    with pytest.raises(ValueError, match="takes lse as float32"):
        tfa.flash_bwd(q, q, q, q, q, lse.double(), True, 0.25)
    with pytest.raises(ValueError, match="takes lse as float32"):
        tfa._launch(q, q, q, True, 0.25, lse=torch.zeros((1, 1, 9)))
    assert loads == []
