"""The port's CUDA flash kernels on the card, beyond the smoke's shapes.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
card's machine has no JAX, so run them there without the suite's
conftest (which imports it), from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_flash_kernel.py

- The kernel that ``kernel_for`` picks against its plain version over
  head_dim 8 to 256, ragged and unequal q/kv lengths, causal and not,
  bf16 and f32, within ``chip_smoke.py``'s tolerance and on its inputs.
  bf16 at head_dim 64 and 128 runs the wgmma kernel
  (``flash_fwd_sm90.cu``), the rest the FFMA kernel (``flash_fwd.cu``).
- Each kernel by name over the shapes the other one serves: the wgmma
  kernel at head_dim 64 and 128 with ragged, unequal and short kv; the
  FFMA kernel on bf16 at head_dim 64 and 128.
- Planted faults: copies of a kernel's source, each with one part
  broken, must fail that same check. This shows the check is tight
  enough to catch them. In flash_fwd.cu: the accumulator's rescale, the
  tile that holds the causal diagonal, the ragged-kv mask. In
  flash_fwd_sm90.cu: the same three, and P.V without P's low half (P
  rounded once to bf16).
"""

import pytest
import torch

import chip_smoke
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.utils import buildlock


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


@pytest.mark.parametrize("name,line,broken,shape,causal", FAULTS,
                         ids=[f[0].replace(" ", "_") for f in FAULTS])
def test_planted_fault_fails_the_check(gen, tmp_path, monkeypatch, name,
                                       line, broken, shape, causal):
    with open(fa._SOURCE) as f:
        text = f.read()
    assert text.count(line) == 1, "the kernel source no longer has %r" % line
    src = tmp_path / "flash_fwd.cu"
    src.write_text(text.replace(line, broken))
    monkeypatch.setattr(fa, "_lib",
                        fa.bind(buildlock.load(str(src), str(tmp_path))))
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
    with open(fa._SOURCE_SM90) as f:
        text = f.read()
    assert text.count(line) == 1, "the kernel source no longer has %r" % line
    src = tmp_path / "flash_fwd_sm90.cu"
    src.write_text(text.replace(line, broken))
    monkeypatch.setattr(fa, "_lib_sm90", fa.bind_sm90(
        buildlock.load(str(src), str(tmp_path))))
    out, ref = _run(gen, shape, causal, torch.bfloat16, "sm90")
    with pytest.raises(AssertionError, match="disagrees") as exc:
        chip_smoke.check_flash(out, ref, torch.bfloat16, name)
    print("planted sm90 fault %r at %s causal=%s: %s"
          % (name, shape, causal, exc.value))
