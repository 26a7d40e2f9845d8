"""The port's CUDA flash kernel on the card, beyond the smoke's shapes.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
card's machine has no JAX, so run them there without the suite's
conftest (which imports it), from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_flash_kernel.py

- The kernel against its plain version over head_dim 8 to 256, ragged
  and unequal q/kv lengths, causal and not, bf16 and f32, within
  ``chip_smoke.py``'s tolerance and on its inputs.
- Planted faults: copies of the kernel source, each with one part
  broken (the accumulator's rescale, the tile that holds the causal
  diagonal, the ragged-kv mask), must fail that same check. This shows
  the check is tight enough to catch them.
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


def _run(gen, shape, causal, dtype):
    b, h, s, sk, d = shape
    q, k, v = chip_smoke.flash_inputs(b, h, s, sk, d, dtype, gen)
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
    out, ref = _run(gen, shape, causal, torch.bfloat16)
    with pytest.raises(AssertionError, match="disagrees") as exc:
        chip_smoke.check_flash(out, ref, torch.bfloat16, name)
    print("planted fault %r at %s causal=%s: %s"
          % (name, shape, causal, exc.value))
