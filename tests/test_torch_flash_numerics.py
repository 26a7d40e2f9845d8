"""Which flash kernel a launch takes, why the sm90 kernel splits P, why
the tf32x3 kernel splits every operand, and why the sm90 backward splits
P and dS.

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
- ``bwd_kernel_for`` sends bf16 at head_dim 64 and 128 to the bf16
  wgmma backward (``csrc/flash_bwd_sm90.cu``) and everything else to the FFMA
  one (``csrc/flash_bwd.cu``); asked for by name, the sm90 backward
  refuses what it does not take before any library loads.
- The numerics decision behind the sm90 backward. :func:`emulate_sm90_bwd`
  repeats its arithmetic in plain torch: f32 scores and dp from bf16
  operands (exact products, f32 sums), the scale after the product, P
  from the lse that the emulated sm90 forward leaves (its own order:
  product, then scale, then the online softmax over 64-key tiles) and
  dS in f32, then rounded to bf16 once or split into hi and lo before the
  products that take them. On ``chip_smoke.bwd_phase``'s inputs the split
  passes ``chip_smoke.check_grads`` (``BWD_TOL``) by a wide margin;
  rounding once passes only narrowly, and its margin shrinks as the
  tensors grow.

Run as a script, it prints each emulation's worst excess over the
check's limit at the smoke's own sizes (b4 h12 d64; the backward's at
b1 h2 and b4 h12):

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


def emulate_sm90(q, k, v, causal, sm_scale, split, return_lse=False):
    """The sm90 kernel's arithmetic in plain torch, with P rounded to
    bf16 once (``split`` False) or as hi + lo (``split`` True); with
    ``return_lse``, (out, lse) as the kernel writes them."""
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
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).to(torch.bfloat16)
    return (out, m + torch.log(l)) if return_lse else out


# (s, sk, causal): the smoke's bf16 cases at head_dim 64
CASES = [(1024, 1024, True), (1024, 1024, False), (1000, 1000, True),
         (1024, 24, False), (100, 1000, False)]


def _inputs(b, h, s, sk, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    return chip_smoke.flash_inputs(b, h, s, sk, 64, dtype, gen, device="cpu")


def _split(x, split):
    """f32 ``x`` as the bf16 operands of the products that take it: its
    bf16 rounding, and (``split``) the bf16 rounding of the remainder."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def emulate_sm90_bwd(q, k, v, out, g, causal, scale, split, drop_lo=None):
    """The sm90 backward's arithmetic in plain torch: (dq, dk, dv) in
    bf16 from the lse that the sm90 forward writes (:func:`emulate_sm90`'s
    order of operations) and delta = rowsum(g * out). s and dp are
    f32 sums of exact products of the bf16 inputs, the scale applied
    after the product; P = exp(s * scale - lse) (0 where masked) and
    dS = P (dp - delta) in f32; each is rounded to bf16 once (``split``
    False) or split into hi and lo (``split`` True) before the products
    that take it (dv = P^T g, dk = dS^T q, dq = dS k), whose terms are
    summed in f32; dq and dk take the scale at the end. ``drop_lo``
    ("dv", "dk" or "dq") drops the lo term of that one product."""
    s, sk = q.shape[2], k.shape[2]
    lse = emulate_sm90(q, k, v, causal, scale, True, return_lse=True)[1]
    delta = fa.flash_bwd_delta_reference(out, g)
    q32, k32, v32, g32 = (x.float() for x in (q, k, v, g))
    mask = fa._block_mask(0, sk, s, sk, causal, q.device)
    scores = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", g32, v32) - delta[..., None])
    op = lambda x, name: _split(x, split and drop_lo != name)
    dv = sum(torch.einsum("bhqk,bhqd->bhkd", x, g32) for x in op(p, "dv"))
    dk = sum(torch.einsum("bhqk,bhqd->bhkd", x, q32)
             for x in op(ds, "dk")) * scale
    dq = sum(torch.einsum("bhqk,bhkd->bhqd", x, k32)
             for x in op(ds, "dq")) * scale
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _bwd_inputs(b, h, s, sk, d=64):
    """``chip_smoke.bwd_phase``'s inputs on the CPU (its seed, bf16):
    q, k, v and g."""
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 5)
    q, k, v = chip_smoke.flash_inputs(b, h, s, sk, d, torch.bfloat16, gen,
                                      device="cpu")
    g = torch.randn((b, h, s, d), generator=gen).to(torch.bfloat16)
    return q, k, v, g


def bwd_margin(b, h, s, sk, causal, split, d=64):
    """The emulated sm90 backward's worst excess over ``check_grads``'s
    atol (the check passes at or below 1) against
    ``flash_bwd_reference``, which recomputes the row statistics with the
    scale before the product; raises where the check fails."""
    q, k, v, g = _bwd_inputs(b, h, s, sk, d)
    scale = d ** -0.5
    out = fa.blockwise_reference(q, k, v, causal, scale)
    want = fa.flash_bwd_reference(q, k, v, out, g, causal, scale)
    got = emulate_sm90_bwd(q, k, v, out, g, causal, scale, split)
    return chip_smoke.check_grads(got, want, torch.bfloat16,
                                  ("emulated sm90 backward", s, sk, d, causal,
                                   "split" if split else "rounded once"))[1]


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


@pytest.mark.parametrize("dtype,head_dim,kernel", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 96, "ffma"), (torch.bfloat16, 8, "ffma"),
    (torch.float32, 64, "ffma"), (torch.float32, 128, "ffma"),
])
def test_bwd_kernel_for_picks_by_dtype_and_head_dim(dtype, head_dim, kernel):
    assert fa.bwd_kernel_for(dtype, head_dim) == kernel
    assert fa.bwd_kernel_names(kernel)[0] == "bwd_delta"


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
    (torch.float32, 64), (torch.bfloat16, 96), (torch.bfloat16, 256),
])
def test_sm90_backward_refuses_what_it_does_not_take(monkeypatch, dtype,
                                                     head_dim):
    """Asked for by name, the sm90 backward (dq, dk/dv and the whole of
    ``flash_bwd``) refuses anything but bf16 at head_dim 64 or 128, and
    every
    backward refuses a kernel it does not have, before any library
    loads: nothing gives way to the FFMA kernels."""
    loads = []
    monkeypatch.setattr(fa, "_kernel_lib", loads.append)
    q = torch.zeros((1, 1, 8, head_dim), dtype=dtype)
    lse = torch.zeros((1, 1, 8))
    scale = head_dim ** -0.5
    for call in (lambda kernel: fa._bwd_dq(q, q, q, q, lse, lse, True,
                                           scale, kernel),
                 lambda kernel: fa._bwd_dkdv(q, q, q, q, lse, lse, True,
                                             scale, kernel),
                 lambda kernel: fa.flash_bwd(q, q, q, q, q, lse, True, scale,
                                             kernel)):
        with pytest.raises(ValueError, match="takes bfloat16 at head_dim"):
            call("sm90")
        with pytest.raises(ValueError, match="no flash backward kernel"):
            call("triton")
    assert loads == []


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
        "sm90": 0, "tf32x3": 0, "ffma": 0, "bwd_delta": 0, "bwd_dq": 0,
        "bwd_dkdv": 0, "bwd_dq_sm90": 0, "bwd_dkdv_sm90": 0}


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


# (s, sk, causal, d): the backward's cases, CASES and the smoke's causal
# s < sk (kv rows that no query reaches) at head_dim 64, and two at 128,
# where the scale 128**-0.5 is not a power of two, so scaling after the
# product (the kernels' lse) and before it (the reference's) round apart
BWD_CASES = [c + (64,) for c in CASES + [(100, 1000, True)]] + [
    (1024, 1024, True, 128), (1000, 1000, False, 128)]


@pytest.mark.parametrize("s,sk,causal,d", BWD_CASES,
                         ids=["s%dsk%d%s%s" % (s, sk, "c" if c else "f",
                                               "" if d == 64 else "d%d" % d)
                              for s, sk, c, d in BWD_CASES])
def test_sm90_backward_split_passes_the_check(s, sk, causal, d):
    """P and dS split into bf16 hi and lo, P taken from the emulated
    forward's lse: the emulated sm90 backward passes ``check_grads``
    (the unchanged ``BWD_TOL``) against ``flash_bwd_reference`` with room
    to spare."""
    assert bwd_margin(1, 2, s, sk, causal, True, d) < 0.05


@pytest.mark.parametrize("drop_lo", [None, "dv", "dk", "dq"])
def test_paired_inputs_show_a_dropped_lo_term(drop_lo):
    """On ``chip_smoke.paired_inputs`` (nearly cancelling pairs), the
    split passes ``check_grads`` and dropping the lo term of any one
    product (P in dv, dS in dk or in dq) fails it: the inputs of the
    card-only tests' planted faults, shown on the CPU."""
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 5)
    q, k, v, g = chip_smoke.paired_inputs(1, 2, 256, 256, 64, torch.bfloat16,
                                          gen, device="cpu")
    out = fa.blockwise_reference(q, k, v, False, 0.125)
    want = fa.flash_bwd_reference(q, k, v, out, g, False, 0.125)
    got = emulate_sm90_bwd(q, k, v, out, g, False, 0.125, True, drop_lo)
    if drop_lo is None:
        assert chip_smoke.check_grads(got, want, torch.bfloat16,
                                      "paired, split")[1] < 0.1
    else:
        with pytest.raises(AssertionError, match=" %s max_abs_err" % drop_lo):
            chip_smoke.check_grads(got, want, torch.bfloat16,
                                   "paired, no lo in " + drop_lo)


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
    print("the sm90 backward vs flash_bwd_reference, check_grads: worst "
          "excess over the atol")
    for b, h in ((1, 2), (4, 12)):
        for s, sk, causal, d in BWD_CASES:
            try:
                once = "%.4fx" % bwd_margin(b, h, s, sk, causal, False, d)
            except AssertionError as e:
                once = "fails (%s)" % str(e).split(": ")[-1]
            print("b%d h%d s=%d sk=%d d=%d %s: P, dS rounded once %s, split "
                  "%.4fx" % (b, h, s, sk, d, "causal" if causal else "full",
                             once, bwd_margin(b, h, s, sk, causal, True, d)))


if __name__ == "__main__":
    main()
