"""The port's CUDA flash kernels on the card, beyond the smoke's shapes.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
card's machine has no JAX, so run them there without the suite's
conftest (which imports it), from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_flash_kernel.py

The tf32x3 kernel's cases alone:

    python -m pytest --noconftest -p no:cacheprovider -q -s \
        tests/test_torch_flash_kernel.py -k tf32x3

The backward kernels' cases alone: ``-k backward``; the bf16 wgmma
backward's (``flash_bwd_sm90.cu``) alone: ``-k sm90_backward``.

- The kernel that ``kernel_for`` picks against its plain version over
  head_dim 8 to 256, ragged and unequal q/kv lengths, causal and not,
  bf16 and f32, within ``chip_smoke.py``'s tolerance and on its inputs.
  bf16 at head_dim 64 and 128 runs the bf16 wgmma kernel
  (``flash_fwd_sm90.cu``), f32 at head_dim 64 the TF32 wgmma kernel
  (``flash_fwd_tf32x3.cu``), the rest the FFMA kernel
  (``flash_fwd.cu``).
- Each kernel by name over the shapes the others serve: the wgmma
  kernels at their head dims with ragged, unequal and short kv; the
  FFMA kernel on bf16 at head_dim 64 and 128.
- The lse each forward kernel writes when asked: the output unchanged
  bit for bit, every row's lse within ``chip_smoke.LSE_TOL`` of the
  backward's pass 1 (``flash_bwd_stats_reference``), nothing written
  past the rows.
- The backward (``bwd_delta`` and the dq and dk/dv kernels that
  ``bwd_kernel_for`` picks: ``flash_bwd_sm90.cu`` for bf16 at head_dim
  64 and 128, ``flash_bwd.cu`` otherwise), on the lse the forward kernel
  wrote, against ``flash_bwd_reference`` (which recomputes the row
  statistics) over the same shapes, causal and not, bf16 and f32, within
  ``chip_smoke.check_grads``; ``bwd_delta`` against the plain delta
  (``chip_smoke.check_delta``); the sm90 backward by name at its bf16
  shapes (ragged, unequal, short kv, odd lengths), its lse and delta
  followed by NaN so that a read past s shows, and on
  ``chip_smoke.paired_inputs``; the gradient through
  ``flash_attention`` and ``mha`` by autograd.
- Planted faults: copies of a kernel's source, each with one part
  broken, must fail that same check. This shows the check is tight
  enough to catch them. In flash_fwd.cu: the accumulator's rescale, the
  tile that holds the causal diagonal, the ragged-kv mask. In
  flash_fwd_sm90.cu: the same three, and P.V without P's low half (P
  rounded once to bf16). In flash_fwd_tf32x3.cu: the same three, and
  no lo terms anywhere (TF32 alone). In each of the three: the lse
  written as m alone, without log(l) (``chip_smoke.check_lse``). In
  flash_bwd.cu: kv tiles that no
query reaches returning early, so that their dk and dv rows keep the
allocator's junk (causal, s < sk), and ``bwd_delta`` summing all but the
last 8 columns of each row (``check_delta``, and ``check_grads`` of the
backward that takes it). In
flash_bwd_sm90.cu: P's lo term dropped in dv, dS's lo term dropped in
dk and in dq (on ``paired_inputs``, where rounding once shows), query
rows past s left unmasked in dk/dv (their lse read past the tensor,
where NaN lies), dk/dv's causal q loop starting one tile late, and
dq's causal kv loop stopping before its diagonal tile.
"""

import glob
import os
import shutil

import pytest
import torch

import chip_smoke
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.utils import buildlock

from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA flash kernel runs only "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)


def _run(gen, shape, causal, dtype, kernel=None):
    """A kernel's output and its plain version's: ``kernel`` by name, or
    the one ``flash_attention`` picks."""
    b, h, s, sk, d = shape
    q, k, v = chip_smoke.flash_inputs(b, h, s, sk, d, dtype, gen)
    if kernel:
        out = fa._launch(q, k, v, causal, d ** -0.5, kernel)
    else:
        out = fa.flash_attention(q, k, v, causal)
    return out, fa.blockwise_reference(q, k, v, causal, d ** -0.5)


SHAPES = [  # (b, h, s, sk, d)
    (4, 12, 1024, 1024, 64),
    (1, 2, 1000, 1000, 64),
    (2, 3, 100, 1000, 40),
    (1, 2, 256, 128, 128),
    (1, 1, 64, 64, 256),
    (1, 1, 70, 70, 8),
    (2, 2, 1024, 24, 64),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["b%dh%ds%dsk%dd%d" % x for x in SHAPES])
def test_kernel_matches_plain_version(gen, shape, causal, dtype):
    out, ref = _run(gen, shape, causal, dtype)
    chip_smoke.check_flash(out, ref, dtype, (shape, causal, dtype))


SM90_SHAPES = [  # (b, h, s, sk, d)
    (4, 12, 1024, 1024, 64), (1, 2, 1000, 1000, 64),
    (2, 3, 100, 1000, 64), (2, 2, 1024, 24, 64),
    (4, 6, 1024, 1024, 128), (1, 2, 1000, 1000, 128),
    (2, 3, 100, 1000, 128), (2, 2, 1024, 24, 128),
    (1, 1, 1, 1, 64), (1, 3, 65, 130, 128),
]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SM90_SHAPES,
                         ids=["b%dh%ds%dsk%dd%d" % x for x in SM90_SHAPES])
def test_sm90_kernel_matches_plain_version(gen, shape, causal):
    out, ref = _run(gen, shape, causal, torch.bfloat16, "sm90")
    chip_smoke.check_flash(out, ref, torch.bfloat16, ("sm90", shape, causal))


TF32X3_SHAPES = [x for x in SM90_SHAPES if x[4] == 64] + [(1, 3, 65, 130, 64)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", TF32X3_SHAPES,
                         ids=["b%dh%ds%dsk%dd%d" % x for x in TF32X3_SHAPES])
def test_tf32x3_kernel_matches_plain_version(gen, shape, causal):
    out, ref = _run(gen, shape, causal, torch.float32, "tf32x3")
    chip_smoke.check_flash(out, ref, torch.float32, ("tf32x3", shape, causal))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_ffma_kernel_on_bf16_at_sm90_head_dims(gen, d, causal):
    shape = (2, 3, 1000, 1000, d)
    out, ref = _run(gen, shape, causal, torch.bfloat16, "ffma")
    chip_smoke.check_flash(out, ref, torch.bfloat16, ("ffma", shape, causal))


# (name, a line of flash_fwd.cu, its broken form, the shape that shows it
# and whether causal)
FAULTS = [
    ("no rescale", "for (int j = 0; j < OJ; ++j) acc[i][j] *= corr;", "",
     (4, 12, 1024, 1024, 64), True),
    ("no diagonal tile", "const int last = (q0 + BM - 1) / BN + 1;",
     "const int last = (q0 + BM - 1) / BN;", (4, 12, 1024, 1024, 64), True),
    ("no ragged mask", "ok[j] = kp < sk && (!causal || qp >= kp);",
     "ok[j] = !causal || qp >= kp;", (4, 12, 1024, 24, 64), False),
]


def _planted(tmp_path, source, line, broken):
    """Build a copy of ``source`` with ``line`` replaced by ``broken``,
    beside copies of the headers it includes; returns its library."""
    with open(source) as f:
        text = f.read()
    assert text.count(line) == 1, "the kernel source no longer has %r" % line
    for header in glob.glob(os.path.join(os.path.dirname(source), "*.cuh")):
        shutil.copy(header, tmp_path)
    src = tmp_path / os.path.basename(source)
    src.write_text(text.replace(line, broken))
    return buildlock.load(str(src), str(tmp_path))


@pytest.mark.parametrize("name,line,broken,shape,causal", FAULTS,
                         ids=[f[0].replace(" ", "_") for f in FAULTS])
def test_planted_fault_fails_the_check(gen, tmp_path, monkeypatch, name,
                                       line, broken, shape, causal):
    monkeypatch.setattr(fa, "_lib", fa.bind(
        _planted(tmp_path, fa._SOURCE, line, broken)))
    out, ref = _run(gen, shape, causal, torch.bfloat16, "ffma")
    with pytest.raises(AssertionError, match="disagrees") as exc:
        chip_smoke.check_flash(out, ref, torch.bfloat16, name)
    print("planted fault %r at %s causal=%s: %s"
          % (name, shape, causal, exc.value))


# (name, a line of flash_fwd_sm90.cu, its broken form, the shape that
# shows it and whether causal)
SM90_FAULTS = [
    ("no rescale", "acc[4 * (e / 2) + 2 * i + e % 2] *= corr;",
     "acc[4 * (e / 2) + 2 * i + e % 2] *= 1.f;", (4, 12, 1024, 1024, 64),
     True),
    ("no diagonal tile", "const int last = (q0 + BM - 1) / BN + 1;",
     "const int last = (q0 + BM - 1) / BN;", (4, 12, 1024, 1024, 64), True),
    ("no ragged mask", "if (edge) ok = kp < sk && (!causal || qp >= kp);",
     "if (edge) ok = !causal || qp >= kp;", (4, 12, 1024, 24, 64), False),
    ("no P_lo", "wgmma_rs(acc, p_lo[kk], dv);", "",
     (4, 12, 1024, 1024, 64), True),
]


@pytest.mark.parametrize("name,line,broken,shape,causal", SM90_FAULTS,
                         ids=[f[0].replace(" ", "_") for f in SM90_FAULTS])
def test_sm90_planted_fault_fails_the_check(gen, tmp_path, monkeypatch, name,
                                            line, broken, shape, causal):
    monkeypatch.setattr(fa, "_lib_sm90", fa.bind_sm90(
        _planted(tmp_path, fa._SOURCE_SM90, line, broken)))
    out, ref = _run(gen, shape, causal, torch.bfloat16, "sm90")
    with pytest.raises(AssertionError, match="disagrees") as exc:
        chip_smoke.check_flash(out, ref, torch.bfloat16, name)
    print("planted sm90 fault %r at %s causal=%s: %s"
          % (name, shape, causal, exc.value))


# (name, a line of flash_fwd_tf32x3.cu, its broken form, the shape that
# shows it and whether causal)
TF32X3_FAULTS = [
    ("no rescale",
     "acc[e] = acc[e] * corr[(e >> 1) & 1] + (pv[e] + pv_lo[e]);",
     "acc[e] = acc[e] + (pv[e] + pv_lo[e]);", (4, 12, 1024, 1024, 64),
     True),
    ("no diagonal tile", "const int last = (q0 + BM - 1) / BN + 1;",
     "const int last = (q0 + BM - 1) / BN;", (4, 12, 1024, 1024, 64), True),
    ("no ragged mask", "if (edge) ok = kp < sk && (!causal || qp >= kp);",
     "if (edge) ok = !causal || qp >= kp;", (4, 12, 1024, 24, 64), False),
    ("no lo terms",
     "__device__ __forceinline__ float tf32_lo(float x, float hi) "
     "{ return x - hi; }",
     "__device__ __forceinline__ float tf32_lo(float x, float hi) "
     "{ return 0.f; }", (4, 12, 1024, 1024, 64), True),
]


@pytest.mark.parametrize("name,line,broken,shape,causal", TF32X3_FAULTS,
                         ids=[f[0].replace(" ", "_") for f in TF32X3_FAULTS])
def test_tf32x3_planted_fault_fails_the_check(gen, tmp_path, monkeypatch,
                                              name, line, broken, shape,
                                              causal):
    monkeypatch.setattr(fa, "_lib_tf32x3", fa.bind_tf32x3(
        _planted(tmp_path, fa._SOURCE_TF32X3, line, broken)))
    out, ref = _run(gen, shape, causal, torch.float32, "tf32x3")
    with pytest.raises(AssertionError, match="disagrees") as exc:
        chip_smoke.check_flash(out, ref, torch.float32, name)
    print("planted tf32x3 fault %r at %s causal=%s: %s"
          % (name, shape, causal, exc.value))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["b%dh%ds%dsk%dd%d" % x for x in SHAPES])
def test_forward_lse_matches_pass_one(gen, shape, causal, dtype):
    """The kernel that ``kernel_for`` picks, launched with an lse buffer
    (NaN before, and a NaN tail after it): the output is the launch
    without lse bit for bit, every row's lse is the backward's pass 1
    within ``LSE_TOL``, and the tail stays NaN."""
    b, h, s, sk, d = shape
    q, k, v = chip_smoke.flash_inputs(b, h, s, sk, d, dtype, gen)
    out, lse = chip_smoke.launch_with_lse(q, k, v, causal, tail=64)
    assert torch.equal(out, fa.flash_attention(q, k, v, causal))
    chip_smoke.check_lse(lse, fa.flash_bwd_stats_reference(
        q, k, out, out, causal, d ** -0.5)[0], (shape, causal, dtype))


# (kernel, its source's library attribute and binder, dtype): the line
# that writes lse is the same in all three sources
LSE_FAULT = ("m[i] + logf(denom);", "m[i];")
LSE_FAULT_KERNELS = [
    ("sm90", "_lib_sm90", fa.bind_sm90, torch.bfloat16),
    ("tf32x3", "_lib_tf32x3", fa.bind_tf32x3, torch.float32),
    ("ffma", "_lib", fa.bind, torch.bfloat16),
]


@pytest.mark.parametrize("kernel,attr,binder,dtype", LSE_FAULT_KERNELS,
                         ids=[f[0] for f in LSE_FAULT_KERNELS])
def test_lse_without_log_l_fails_the_check(gen, tmp_path, monkeypatch,
                                           kernel, attr, binder, dtype):
    """A forward that writes m without log(l) fails ``check_lse``, and
    the backward that takes its lse fails ``check_grads``."""
    monkeypatch.setattr(fa, attr, binder(
        _planted(tmp_path, fa.SOURCES[kernel], *LSE_FAULT)))
    b, h, s, sk, d = shape = (2, 12, 1024, 1024, 64)
    q, k, v = chip_smoke.flash_inputs(b, h, s, sk, d, dtype, gen)
    g = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
    out, lse = chip_smoke.launch_with_lse(q, k, v, True, kernel)
    with pytest.raises(AssertionError, match="disagrees") as exc:
        chip_smoke.check_lse(lse, fa.flash_bwd_stats_reference(
            q, k, out, g, True, d ** -0.5)[0], (kernel, shape))
    print("planted %s fault 'lse without log(l)': %s" % (kernel, exc.value))
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.check_grads(
            fa.flash_bwd(q, k, v, out, g, lse, True, d ** -0.5),
            fa.flash_bwd_reference(q, k, v, out, g, True, d ** -0.5), dtype,
            (kernel, "lse without log(l)"))


def _run_bwd(gen, shape, causal, dtype, kernel=None):
    """The backward kernels' (dq, dk, dv), on the lse the forward kernel
    wrote, and the plain version's (which recomputes the row
    statistics), with NaN junk freed into the allocator first, so that
    rows the kernels do not write show: ``kernel``'s dq and dk/dv by
    name, or the ones ``bwd_kernel_for`` picks. ``bwd_delta`` is held to
    ``check_delta`` on the way."""
    b, h, s, sk, d = shape
    q, k, v = chip_smoke.flash_inputs(b, h, s, sk, d, dtype, gen)
    g = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
    out, lse = chip_smoke.launch_with_lse(q, k, v, causal)
    chip_smoke.check_delta(fa._bwd_delta(out, g), out, g,
                           ("bwd_delta", shape, dtype, causal))
    junk = [torch.full_like(k, float("nan")) for _ in range(2)]
    del junk
    got = fa.flash_bwd(q, k, v, out, g, lse, causal, d ** -0.5, kernel)
    torch.cuda.synchronize()
    return got, fa.flash_bwd_reference(q, k, v, out, g, causal, d ** -0.5)


BWD_SHAPES = SHAPES + [(1, 2, 100, 1000, 64), (1, 3, 65, 130, 128),
                       (2, 4, 256, 256, 96)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=["b%dh%ds%dsk%dd%d" % x for x in BWD_SHAPES])
def test_backward_matches_plain_version(gen, shape, causal, dtype):
    got, want = _run_bwd(gen, shape, causal, dtype)
    chip_smoke.check_grads(got, want, dtype, ("backward", shape, causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_backward_autograd_through_mha(gen, dtype):
    """The gradient of ``mha`` (the model layout) by autograd: the
    backward kernels, one launch each, against the plain backward on the
    same (q, k, v, out, g) in the kernels' layout."""
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
               for t in chip_smoke.flash_inputs(2, 4, 300, 300, 64, dtype,
                                                gen))
    g = torch.randn_like(q)
    fa.reset_launches()
    out = fa.mha(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), g)
    names = fa.bwd_kernel_names(fa.bwd_kernel_for(dtype, 64))
    assert [fa.flash_attention.kernel_launches[n] for n in names] == [1, 1, 1]
    assert fa.flash_attention.launches == 4  # and one forward
    t = lambda x: x.detach().transpose(1, 2).contiguous()
    want = fa.flash_bwd_reference(t(q), t(k), t(v), t(out), t(g), True,
                                  64 ** -0.5)
    chip_smoke.check_grads([t(x) for x in got], want, dtype, "mha")


# (name, a line of flash_bwd.cu, its broken form, the shape that shows it
# and whether causal)
BWD_FAULTS = [
    ("unreached kv rows left unwritten",
     "const int first = causal ? k0 / B : 0;",
     "if (causal && k0 >= s) return;  // planted\n"
     "  const int first = causal ? k0 / B : 0;", (1, 2, 100, 1000, 64),
     True),
    ("bwd_delta drops the last 8 columns",
     "const int chunks = d / EV;           // a row's 16-byte vectors",
     "const int chunks = (d - 8) / EV;", (2, 2, 256, 256, 64), False),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name,line,broken,shape,causal", BWD_FAULTS,
                         ids=[f[0].replace(" ", "_") for f in BWD_FAULTS])
def test_backward_planted_fault_fails_the_check(gen, tmp_path, monkeypatch,
                                                name, line, broken, shape,
                                                causal, dtype):
    monkeypatch.setattr(fa, "_lib_bwd", fa.bind_bwd(
        _planted(tmp_path, fa._SOURCE_BWD, line, broken)))
    with pytest.raises(AssertionError, match="disagrees") as exc:
        got, want = _run_bwd(gen, shape, causal, dtype, "ffma")
        chip_smoke.check_grads(got, want, dtype, name)
    print("planted backward fault %r at %s causal=%s: %s"
          % (name, shape, causal, exc.value))


def _nan_tail(x):
    """``x`` copied to the front of a buffer whose tail (64 values) is
    NaN: a kernel that reads past its end makes NaN."""
    buf = torch.full((x.numel() + 64,), float("nan"), dtype=x.dtype,
                     device=x.device)
    buf[:x.numel()] = x.flatten()
    return buf[:x.numel()].view_as(x)


def _run_sm90_bwd(gen, shape, causal, paired=False):
    """The sm90 backward by name (the forward's lse and ``bwd_delta``'s
    delta, then ``bwd_dq_sm90`` and ``bwd_dkdv_sm90`` on lse and delta
    with a NaN tail, NaN junk freed
    into the allocator first) and the plain version's gradients; on
    ``chip_smoke.paired_inputs`` when ``paired``."""
    b, h, s, sk, d = shape
    scale = d ** -0.5
    if paired:
        q, k, v, g = chip_smoke.paired_inputs(b, h, s, sk, d, torch.bfloat16,
                                              gen)
    else:
        q, k, v = chip_smoke.flash_inputs(b, h, s, sk, d, torch.bfloat16,
                                          gen)
        g = torch.randn((b, h, s, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
    out, lse = chip_smoke.launch_with_lse(q, k, v, causal)
    lse, delta = _nan_tail(lse), _nan_tail(fa._bwd_delta(out, g))
    junk = [torch.full_like(k, float("nan")) for _ in range(2)]
    del junk
    fa.reset_launches()
    dq = fa._bwd_dq(q, k, v, g, lse, delta, causal, scale, "sm90")
    dk, dv = fa._bwd_dkdv(q, k, v, g, lse, delta, causal, scale, "sm90")
    torch.cuda.synchronize()
    assert fa.flash_attention.kernel_launches["bwd_dq_sm90"] == 1
    assert fa.flash_attention.kernel_launches["bwd_dkdv_sm90"] == 1
    return (dq, dk, dv), fa.flash_bwd_reference(q, k, v, out, g, causal,
                                                scale)


# the sm90 forward's shapes at the head dims the sm90 backward takes, but
# s = sk = 1 (one key: dq and dk are exactly zero, and with them the
# check's atol) in favour of one query row over ragged kv
BWD_SM90_SHAPES = [x for x in SM90_SHAPES
                   if x[4] in fa.BWD_SM90_HEAD_DIMS and x[2] > 1] + [
    (1, 1, 1, 70, 64), (1, 3, 65, 130, 64), (2, 2, 130, 65, 64),
    (8, 12, 1024, 1024, 64)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", BWD_SM90_SHAPES,
                         ids=["b%dh%ds%dsk%dd%d" % x for x in BWD_SM90_SHAPES])
def test_sm90_backward_matches_plain_version(gen, shape, causal):
    got, want = _run_sm90_bwd(gen, shape, causal)
    chip_smoke.check_grads(got, want, torch.bfloat16,
                           ("sm90 backward", shape, causal))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_sm90_backward_on_paired_inputs(gen, causal):
    """Nearly cancelling pairs, where a bf16 rounding of P or dS would
    show: the split keeps the check."""
    got, want = _run_sm90_bwd(gen, (4, 12, 1024, 1024, 64), causal, True)
    chip_smoke.check_grads(got, want, torch.bfloat16,
                           ("sm90 backward, paired", causal))


# (name, a line of flash_bwd_sm90.cu, its broken form, the shape that
# shows it, whether causal, whether on paired inputs)
BWD_SM90_FAULTS = [
    ("no P_lo in dv", "wgmma_rs(dv_acc, p_lo[kk], g_kk);", "",
     (4, 12, 1024, 1024, 64), False, True),
    ("no dS_lo in dk", "wgmma_rs(dk_acc, ds_lo[kk], q_kk);", "",
     (4, 12, 1024, 1024, 64), False, True),
    ("no dS_lo in dq", "wgmma_rs(dq_acc, ds_lo[kk], k_kk);", "",
     (4, 12, 1024, 1024, 64), False, True),
    ("q rows past s unmasked in dk/dv", "const bool in = qp < s;",
     "const bool in = true;", (1, 2, 100, 1000, 64), False, False),
    ("causal q loop one tile late",
     "const int first = causal ? k0 / BM : 0;",
     "const int first = causal ? k0 / BM + 1 : 0;", (4, 12, 1024, 1024, 64),
     True, False),
    ("no diagonal tile in dq",
     "if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BM + 1);",
     "if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BM);",
     (4, 12, 1024, 1024, 64), True, False),
]


@pytest.mark.parametrize("name,line,broken,shape,causal,paired",
                         BWD_SM90_FAULTS,
                         ids=[f[0].replace(" ", "_").replace("/", "")
                              for f in BWD_SM90_FAULTS])
def test_sm90_backward_planted_fault_fails_the_check(
        gen, tmp_path, monkeypatch, name, line, broken, shape, causal,
        paired):
    monkeypatch.setattr(fa, "_lib_bwd_sm90", fa.bind_bwd_sm90(
        _planted(tmp_path, fa._SOURCE_BWD_SM90, line, broken)))
    got, want = _run_sm90_bwd(gen, shape, causal, paired)
    with pytest.raises(AssertionError, match="disagrees") as exc:
        chip_smoke.check_grads(got, want, torch.bfloat16, name)
    print("planted sm90 backward fault %r at %s causal=%s: %s"
          % (name, shape, causal, exc.value))
