"""Which flash kernel a launch takes, why the sm90 kernel splits P, and
why the tf32x3 kernel splits every operand.

On the CPU, no card needed:

- ``kernel_for`` sends bf16 at head_dim 64 and 128 to the bf16 wgmma
  kernel (``csrc/flash_fwd_sm90.cu``), float32 at head_dim 64 to the
  TF32 wgmma kernel (``csrc/flash_fwd_tf32x3.cu``) and everything else
  to the FFMA kernel (``csrc/flash_fwd.cu``); the wrapper refuses a
  kernel that does not take the tensors before it loads any library.
- The numerics decision behind the sm90 kernel's P.V. Its tensor cores
  take bf16 operands, while the reference multiplies f32 probabilities
  by v. :func:`emulate_sm90` repeats the kernel's arithmetic in plain
  torch: f32 scores from bf16 operands, scaled after the product, an f32
  online softmax over 64-key tiles, and P.V with P rounded to bf16 once
  or split into that rounding and the bf16 rounding of its remainder.
  On ``chip_smoke.py``'s inputs, rounding once fails
  ``chip_smoke.check_flash`` and the split passes it.
- The same decision behind the tf32x3 kernel. Its tensor cores multiply
  TF32 (10 mantissa bits), while the reference is f32 throughout.
  :func:`emulate_tf32x3` repeats that kernel's arithmetic: q scaled in
  f32, then every operand (q, K, V, P) rounded to TF32 once
  (``split`` False) or split into that rounding and the remainder, which
  the tensor core reads truncated to TF32 (``split`` True: lo.hi +
  hi.lo + hi.hi). On the smoke's f32 inputs, TF32 alone fails the f32
  check and the split passes it.

Run as a script, it prints each emulation's worst excess over the
check's limit at the smoke's own sizes (b4 h12 d64):

    python tests/test_torch_flash_numerics.py
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from edl_tpu_torch.ops import flash_attention as fa  # noqa: E402

TILE = 64  # the sm90 kernel's kv tile


def tf32_round(x):
    """f32 ``x`` rounded to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``): add half of TF32's last place to the bits,
    then clear the 13 below it."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """f32 ``x`` as the tensor core reads it in a TF32 product: its 13
    lowest bits dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm(eq, a, b, split):
    """The tf32x3 kernel's product of f32 ``a`` and ``b``: TF32 roundings
    only, or lo.hi + hi.lo + hi.hi with lo = x - hi read truncated."""
    ah, bh = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, ah, bh)
    if split:
        al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
        out = (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + out
    return out


def emulate_tf32x3(q, k, v, causal, sm_scale, split):
    """The tf32x3 kernel's arithmetic in plain torch over 64-key tiles:
    q scaled in f32 first, both products from TF32 operands (split into
    hi and lo when ``split``), the f32 online softmax of the reference."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    kb, vb, n_tiles = fa._block_layout(k, v, TILE)
    q32 = q.float() * sm_scale
    acc = torch.zeros((b, h, s, d))
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    for t in range(n_tiles):
        mask = fa._block_mask(t, TILE, s, sk, causal, q.device)
        scores = _mm("bhqd,bhkd->bhqk", q32, kb[t], split)
        scores = torch.where(mask, scores, -1e30)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mm("bhqk,bhkd->bhqd", p, vb[t], split)
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def emulate_sm90(q, k, v, causal, sm_scale, split):
    """The sm90 kernel's arithmetic in plain torch, with P rounded to
    bf16 once (``split`` False) or as hi + lo (``split`` True)."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    kb, vb, n_tiles = fa._block_layout(k, v, TILE)
    q32 = q.float()
    acc = torch.zeros((b, h, s, d))
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    for t in range(n_tiles):
        mask = fa._block_mask(t, TILE, s, sk, causal, q.device)
        scores = torch.einsum("bhqd,bhkd->bhqk", q32, kb[t]) * sm_scale
        scores = torch.where(mask, scores, -1e30)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhqk,bhkd->bhqd", hi, vb[t])
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bhqk,bhkd->bhqd", lo, vb[t])
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(torch.bfloat16)


# (s, sk, causal): the smoke's bf16 cases at head_dim 64
CASES = [(1024, 1024, True), (1024, 1024, False), (1000, 1000, True),
         (1024, 24, False), (100, 1000, False)]


def _inputs(b, h, s, sk, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    return chip_smoke.flash_inputs(b, h, s, sk, 64, dtype, gen, device="cpu")


def excess(out, ref, dtype=torch.bfloat16):
    """The worst |out - ref| - rtol |ref| as a multiple of the check's
    atol (the check passes at or below 1)."""
    atol, rtol = chip_smoke.KERNEL_TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    return (diff - rtol * ref.float().abs()).max().item() / atol


@pytest.mark.parametrize("dtype,head_dim,kernel", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "ffma"),
    (torch.bfloat16, 8, "ffma"), (torch.bfloat16, 40, "ffma"),
    (torch.bfloat16, 96, "ffma"), (torch.bfloat16, 256, "ffma"),
    (torch.float32, 40, "ffma"), (torch.float32, 256, "ffma"),
])
def test_kernel_for_picks_by_dtype_and_head_dim(dtype, head_dim, kernel):
    assert fa.kernel_for(dtype, head_dim) == kernel


@pytest.mark.parametrize("dtype,head_dim,match", [
    (torch.float32, 64, "takes bfloat16"),
    (torch.bfloat16, 96, "takes bfloat16"),
])
def test_sm90_refuses_what_it_does_not_take(dtype, head_dim, match):
    """Asked for by name, the sm90 kernel refuses other dtypes and head
    dims before any library loads: nothing gives way to the other
    kernel."""
    q = torch.zeros((1, 1, 8, head_dim), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa._launch(q, q, q, True, head_dim ** -0.5, "sm90")
    with pytest.raises(ValueError, match="no flash kernel"):
        fa._launch(q, q, q, True, head_dim ** -0.5, "triton")


@pytest.mark.parametrize("dtype,head_dim", [
    (torch.bfloat16, 64), (torch.float32, 128), (torch.float32, 40),
])
def test_tf32x3_refuses_what_it_does_not_take(monkeypatch, dtype, head_dim):
    """Asked for by name, the tf32x3 kernel refuses anything but float32
    at head_dim 64 before any library loads."""
    loads = []
    monkeypatch.setattr(fa, "_kernel_lib", loads.append)
    q = torch.zeros((1, 1, 8, head_dim), dtype=dtype)
    with pytest.raises(ValueError, match="takes float32 at head_dim 64"):
        fa._launch(q, q, q, True, head_dim ** -0.5, "tf32x3")
    assert loads == []


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    q, k, v = _inputs(1, 2, 100, 100)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, True)
    assert torch.equal(out, fa.blockwise_reference(q, k, v, True, 0.125))
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention.kernel_launches == {
        "sm90": 0, "tf32x3": 0, "ffma": 0, "bwd_stats": 0, "bwd_dq": 0,
        "bwd_dkdv": 0}


@pytest.mark.parametrize("s,sk,causal", CASES,
                         ids=["s%dsk%d%s" % (s, sk, "c" if c else "f")
                              for s, sk, c in CASES])
def test_p_rounded_once_fails_the_check_and_the_split_passes(s, sk, causal):
    q, k, v = _inputs(1, 2, s, sk)
    ref = fa.blockwise_reference(q, k, v, causal, 64 ** -0.5)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_flash(emulate_sm90(q, k, v, causal, 0.125, False),
                               ref, torch.bfloat16, "P rounded once")
    chip_smoke.check_flash(emulate_sm90(q, k, v, causal, 0.125, True), ref,
                           torch.bfloat16, "P split")


@pytest.mark.parametrize("s,sk,causal", CASES,
                         ids=["s%dsk%d%s" % (s, sk, "c" if c else "f")
                              for s, sk, c in CASES])
def test_tf32_alone_fails_the_f32_check_and_the_split_passes(s, sk, causal):
    q, k, v = _inputs(1, 2, s, sk, torch.float32)
    ref = fa.blockwise_reference(q, k, v, causal, 64 ** -0.5)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_flash(emulate_tf32x3(q, k, v, causal, 0.125, False),
                               ref, torch.float32, "TF32 alone")
    chip_smoke.check_flash(emulate_tf32x3(q, k, v, causal, 0.125, True), ref,
                           torch.float32, "3xTF32")


def main():
    print("worst |out - ref| - rtol |ref| over the atol, b4 h12 d64")
    for s, sk, causal in CASES:
        what = "s=%d sk=%d %s" % (s, sk, "causal" if causal else "full")
        q, k, v = _inputs(chip_smoke.MAX_BATCH, 12, s, sk)
        ref = fa.blockwise_reference(q, k, v, causal, 64 ** -0.5)
        once, split = (excess(emulate_sm90(q, k, v, causal, 0.125, x), ref)
                       for x in (False, True))
        print("bf16 %s: P rounded once %.2fx, split %.4fx"
              % (what, once, split))
        q, k, v = _inputs(chip_smoke.MAX_BATCH, 12, s, sk, torch.float32)
        ref = fa.blockwise_reference(q, k, v, causal, 64 ** -0.5)
        once, split = (excess(emulate_tf32x3(q, k, v, causal, 0.125, x), ref,
                              torch.float32) for x in (False, True))
        print("f32 %s: TF32 alone %.2fx, 3xTF32 %.4fx"
              % (what, once, split))


if __name__ == "__main__":
    main()
