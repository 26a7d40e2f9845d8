"""ResNet / ResNet-vd / ResNeXt family: ``edl_tpu/models/resnet.py``
ported to PyTorch, bf16 activations over f32 parameters and f32 batch
statistics.

The vd tweaks over vanilla ResNet, as in the JAX package:

- deep stem: three 3x3 convs (32, 32, 64) in place of one 7x7;
- the bottleneck's stride on its 3x3 conv, not on the first 1x1;
- downsampling shortcuts: a 2x2 average pool, then a stride-1 1x1 conv.

``space_to_depth=True`` computes the vd stem's 3x3/stride-2 conv on the
2x2 space-to-depth image as a stride-1 2x2 conv on 12 channels; the
trained parameter stays the [3, 3, 3, 32] kernel, scattered into the
[2, 2, 12, 32] one inside the step, which is exact.

Layout: images arrive NHWC, as in the JAX package; the model computes
in NCHW with the ``channels_last`` memory format (the same bytes), so
``x.permute(0, 3, 1, 2)`` of the input is free. Conv kernels are held
as torch's OIHW; :func:`params_from_flax` transposes flax's HWIO once.

Numerics follow flax's modules: a conv casts its input and kernel to
``dtype``; flax's ``SAME`` padding pads ``max((ceil(n/s) - 1) s + k - n,
0)`` with the smaller half low (a stride-2 3x3 on an even size pads
(0, 1), where torch's ``padding=1`` pads (1, 1)), and the max pool pads
the same way with -inf; BatchNorm is ``ops/batch_norm.py``'s (flax's
``BatchNorm`` when ``bn_stats_every == 1``, else ``SubsetBatchNorm``);
the head averages the bf16 activations in f32, rounds the mean to
``dtype`` (as ``jnp.mean`` of a bf16 array does) and applies an f32
``Dense``.

State: ``params`` is a flat flax-named dict (``stage0_block0.conv1.
kernel``, ``head.bias``, ...) and the running statistics another
(``stage0_block0.bn1.mean``/``.var``). ``forward(x, batch_stats,
train)`` returns ``(logits, batch_stats)``: in train mode the updated
statistics, computed once per step. With ``remat=True`` each residual
block is recomputed in the backward (``torch.utils.checkpoint``); the
recompute's statistics are discarded with the rest of its outputs.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from edl_tpu_torch.models.gpt import remat_call
from edl_tpu_torch.ops.batch_norm import BatchNorm, SubsetBatchNorm
from edl_tpu_torch.utils.device import resolve_device

DEPTH_CONFIGS = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}

# jax.nn.initializers.truncated_normal's correction: the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(param, fan_in, generator):
    """flax's ``lecun_normal``: a unit normal truncated to [-2, 2] (by
    the inverse CDF, as ``jax.random.truncated_normal`` draws it), scaled
    to variance 1 / fan_in."""
    edge = math.erf(2.0 / math.sqrt(2.0))
    sample = torch.empty(param.shape, device=generator.device)
    sample.uniform_(-edge, edge, generator=generator).erfinv_()
    param.copy_(sample * (math.sqrt(2.0) * fan_in ** -0.5 / _TRUNC_STD))


def same_pads(n, k, s):
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, s, value=0.0):
    """``x`` padded for a SAME window ``k``/``s`` on its two spatial dims,
    and the symmetric padding left for the op: (x, 0) after an explicit
    ``F.pad``, or (x, p) when both sides pad ``p``."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k, s),
                          same_pads(x.shape[3], k, s))
    if hl == hh == wl == wh:
        return x, hl
    x = F.pad(x, (wl, wh, hl, hh), value=value)
    return x.contiguous(memory_format=torch.channels_last), 0


def space_to_depth(x, block=2):
    """[B, H, W, C] -> [B, H/b, W/b, b*b*C] (channel = (di*b+dj)*C + c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME",
    use_bias=False, feature_group_count=groups, dtype)``; the kernel is
    held as OIHW [out, in / groups, k, k]."""

    def __init__(self, in_ch, out_ch, k, stride=1, groups=1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.k, self.stride, self.groups, self.dtype = k, stride, groups, dtype
        self.kernel = nn.Parameter(torch.empty(out_ch, in_ch // groups, k, k,
                                               device=device))

    def init_weights(self, generator):
        _lecun_normal_(self.kernel, math.prod(self.kernel.shape[1:]),
                       generator)

    def forward(self, x):
        x, pad = _pad_same(x.to(self.dtype), self.k, self.stride)
        w = self.kernel.to(self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=pad,
                        groups=self.groups)


class S2DStemConv(nn.Module):
    """The vd stem's 3x3/stride-2 conv on 3 channels, computed on the
    space-to-depth image as a stride-1 2x2 conv on 12 channels, padded
    (0, 1) on both dims. The parameter is the [features, 3, 3, 3]
    kernel; its [features, 12, 2, 2] form puts ``w[u, v]`` at tap
    ``(u // 2, v // 2)``, channel ``((u % 2) * 2 + v % 2) * 3 + c``, and
    zeros where the 4x4 region exceeds the 3x3 window."""

    def __init__(self, features, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, 3, 3, 3,
                                               device=device))

    def init_weights(self, generator):
        _lecun_normal_(self.kernel, 27, generator)

    def s2d_kernel(self):
        f = self.kernel.shape[0]
        w = F.pad(self.kernel, (0, 1, 0, 1))  # [f, c, u, v], u, v < 4
        # u = 2 dp + di, v = 2 dq + dj -> [f, (di, dj, c), dp, dq]
        w = w.reshape(f, 3, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4)
        return w.reshape(f, 12, 2, 2)

    def forward(self, y):
        y = F.pad(y.to(self.dtype), (0, 1, 0, 1))
        y = y.contiguous(memory_format=torch.channels_last)
        w = self.s2d_kernel().to(self.dtype,
                                 memory_format=torch.channels_last)
        return F.conv2d(y, w)


class Dense(nn.Module):
    """flax ``nn.Dense`` in the parameters' dtype (f32): ``x @ kernel +
    bias``, kernel [in, out]."""

    def __init__(self, in_features, out_features, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def init_weights(self, generator):
        _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        self.bias.zero_()

    def forward(self, x):
        return x.to(self.kernel.dtype) @ self.kernel + self.bias


def _make_norm(features, dtype, bn_stats_every, device, scale_init=1.0):
    """flax's BatchNorm for full-batch statistics, SubsetBatchNorm (the
    same variables) when they come from every k-th row."""
    if bn_stats_every > 1:
        return SubsetBatchNorm(features, dtype, device, scale_init=scale_init,
                               stats_every=bn_stats_every)
    return BatchNorm(features, dtype, device, scale_init=scale_init)


def name_norms(root):
    """Give each BatchNorm under ``root`` its path from ``root``, the
    name of its running statistics (``<path>.mean``, ``<path>.var``)."""
    for name, module in root.named_modules():
        if isinstance(module, BatchNorm):
            module.path = name
    return root


def init_batch_stats(root):
    """Running statistics of the BatchNorms under ``root`` (named by
    :func:`name_norms`) as flax starts them: mean 0, var 1 (f32)."""
    stats = {}
    for module in root.modules():
        if isinstance(module, BatchNorm):
            ones = torch.ones_like(module.scale, requires_grad=False)
            stats[module.path + ".mean"] = torch.zeros_like(ones)
            stats[module.path + ".var"] = ones
    return stats


def _norm(norm, x, stats, updates, train):
    """Apply ``norm`` with its running statistics from ``stats``; in
    train mode record the updated ones in ``updates``."""
    y, mean, var = norm(x, stats[norm.path + ".mean"],
                        stats[norm.path + ".var"], train)
    if train:
        updates[norm.path + ".mean"] = mean
        updates[norm.path + ".var"] = var
    return y


class _Block(nn.Module):
    """The shortcut both block kinds share: identity, or (vd, stride > 1)
    a 2x2 average pool and a 1x1 conv, else a strided 1x1 conv; then a
    BatchNorm."""

    def _shortcut(self, in_ch, out_ch, stride, vd, dtype, bn_stats_every,
                  device):
        self.pool_first = vd and stride > 1
        self.has_downsample = stride != 1 or in_ch != out_ch
        if self.has_downsample:
            self.downsample = Conv(in_ch, out_ch, 1,
                                   1 if self.pool_first else stride,
                                   dtype=dtype, device=device)
            self.downsample_bn = _make_norm(out_ch, dtype, bn_stats_every,
                                            device)

    def _residual(self, x, stats, updates, train):
        if not self.has_downsample:
            return x
        if self.pool_first:
            x = F.avg_pool2d(x, 2, 2)
        return _norm(self.downsample_bn, self.downsample(x), stats, updates,
                     train)


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (strided, grouped for ResNeXt) -> 1x1 (x4), the last
    norm's scale starting at zero; the inner width is
    ``filters * base_width / 64 * groups``."""

    expansion = 4

    def __init__(self, in_ch, filters, stride, vd, dtype=torch.bfloat16,
                 bn_stats_every=1, groups=1, base_width=64, device=None):
        super().__init__()
        width = int(filters * base_width / 64.0) * groups
        norm = lambda c, **kw: _make_norm(c, dtype, bn_stats_every, device,
                                          **kw)
        self.conv1 = Conv(in_ch, width, 1, dtype=dtype, device=device)
        self.bn1 = norm(width)
        self.conv2 = Conv(width, width, 3, stride, groups, dtype, device)
        self.bn2 = norm(width)
        self.conv3 = Conv(width, filters * 4, 1, dtype=dtype, device=device)
        self.bn3 = norm(filters * 4, scale_init=0.0)
        self._shortcut(in_ch, filters * 4, stride, vd, dtype, bn_stats_every,
                       device)

    def forward(self, x, stats, train):
        updates = {}
        y = F.relu(_norm(self.bn1, self.conv1(x), stats, updates, train))
        y = F.relu(_norm(self.bn2, self.conv2(y), stats, updates, train))
        y = _norm(self.bn3, self.conv3(y), stats, updates, train)
        return F.relu(y + self._residual(x, stats, updates, train)), updates


class BasicBlock(_Block):
    """3x3 (strided) -> 3x3, the last norm's scale starting at zero."""

    expansion = 1

    def __init__(self, in_ch, filters, stride, vd, dtype=torch.bfloat16,
                 bn_stats_every=1, device=None):
        super().__init__()
        self.conv1 = Conv(in_ch, filters, 3, stride, dtype=dtype,
                          device=device)
        self.bn1 = _make_norm(filters, dtype, bn_stats_every, device)
        self.conv2 = Conv(filters, filters, 3, dtype=dtype, device=device)
        self.bn2 = _make_norm(filters, dtype, bn_stats_every, device,
                              scale_init=0.0)
        self._shortcut(in_ch, filters, stride, vd, dtype, bn_stats_every,
                       device)

    def forward(self, x, stats, train):
        updates = {}
        y = F.relu(_norm(self.bn1, self.conv1(x), stats, updates, train))
        y = _norm(self.bn2, self.conv2(y), stats, updates, train)
        return F.relu(y + self._residual(x, stats, updates, train)), updates


class ResNet(nn.Module):
    """The JAX package's ``ResNet``, with its options: ``vd`` stem and
    shortcuts, ``space_to_depth`` stem (vd only), per-block ``remat``,
    ``bn_stats_every`` (SubsetBatchNorm above 1), ResNeXt ``groups`` and
    ``base_width`` (bottleneck depths). ``device`` None means CUDA (and
    raises without one). Parameters start uninitialized: call
    :meth:`init_weights`, or load a state (:func:`params_from_flax`)."""

    def __init__(self, depth=50, num_classes=1000, vd=True,
                 dtype=torch.bfloat16, stage_filters=(64, 128, 256, 512),
                 remat=False, space_to_depth=False, bn_stats_every=1,
                 groups=1, base_width=64, device=None):
        super().__init__()
        device = resolve_device(device)
        blocks_per_stage, bottleneck = DEPTH_CONFIGS[depth]
        if not bottleneck and (groups != 1 or base_width != 64):
            raise ValueError("grouped (ResNeXt) blocks need a bottleneck "
                             "depth (>= 50), got depth=%d" % depth)
        if space_to_depth and not vd:
            raise ValueError("the space-to-depth stem is the vd stem's")
        self.dtype, self.vd, self.remat = dtype, vd, remat
        self.space_to_depth = space_to_depth
        self.num_classes = num_classes
        norm = lambda c: _make_norm(c, dtype, bn_stats_every, device)
        conv = lambda i, o, k, s=1: Conv(i, o, k, s, dtype=dtype,
                                         device=device)
        if vd:
            self.stem1 = (S2DStemConv(32, dtype, device) if space_to_depth
                          else conv(3, 32, 3, 2))
            self.stem_bn1 = norm(32)
            self.stem2, self.stem_bn2 = conv(32, 32, 3), norm(32)
            self.stem3, self.stem_bn3 = conv(32, 64, 3), norm(64)
        else:
            self.stem, self.stem_bn = conv(3, 64, 7, 2), norm(64)
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        block_kw = ({"groups": groups, "base_width": base_width}
                    if bottleneck else {})
        self.block_names = []
        in_ch = 64
        for stage, (filters, n_blocks) in enumerate(
                zip(stage_filters, blocks_per_stage)):
            for i in range(n_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                name = "stage%d_block%d" % (stage, i)
                self.add_module(name, block_cls(
                    in_ch, filters, stride, vd, dtype, bn_stats_every,
                    device=device, **block_kw))
                self.block_names.append(name)
                in_ch = filters * block_cls.expansion
        self.head = Dense(in_ch, num_classes, device)
        name_norms(self)

    @torch.no_grad()
    def init_weights(self, generator):
        """Random weights from ``generator`` (on the model's device), as
        flax initializes them: lecun normal kernels, zero biases, BN
        scales at 1 (0 on each block's last norm)."""
        for module in self.modules():
            if module is not self and hasattr(module, "init_weights"):
                module.init_weights(generator)
        return self

    def forward(self, x, batch_stats, train=False):
        """Logits [b, num_classes] (f32) of NHWC images ``x``, and the
        running statistics: updated from this batch when ``train``."""
        updates = {}
        x = x.to(self.dtype)
        if self.space_to_depth:
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)  # NHWC bytes as channels_last NCHW
        stem = ((self.stem1, self.stem_bn1), (self.stem2, self.stem_bn2),
                (self.stem3, self.stem_bn3)) if self.vd else \
            ((self.stem, self.stem_bn),)
        for conv, norm in stem:
            x = F.relu(_norm(norm, conv(x), batch_stats, updates, train))
        x, pad = _pad_same(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, 2, padding=pad)
        use_remat = self.remat and train and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            if use_remat:
                x, upd = remat_call(block, x, batch_stats, train)
            else:
                x, upd = block(x, batch_stats, train)
            updates.update(upd)
        # jnp.mean of bf16: an f32 sum, the mean rounded to bf16
        x = x.mean((2, 3), dtype=torch.promote_types(
            x.dtype, torch.float32)).to(self.dtype)
        return self.head(x), dict(batch_stats, **updates)


def ResNet50_vd(**kw):
    return ResNet(depth=50, vd=True, **kw)


def ResNeXt(depth=101, groups=32, base_width=16, **kw):
    """ResNeXt-{depth} {groups}x{base_width}d (the reference's distill
    teacher ResNeXt101_32x16d_wsl; 'wsl' names the weakly-supervised
    pretraining of its public weights). Vanilla (non-vd) stem by
    default, as the canonical ResNeXt."""
    kw.setdefault("vd", False)
    return ResNet(depth=depth, groups=groups, base_width=base_width, **kw)


def ResNeXt101_32x16d(**kw):
    return ResNeXt(depth=101, groups=32, base_width=16, **kw)


def create_model_and_loss(depth=50, num_classes=1000, vd=True,
                          label_smoothing=0.1,
                          dtype=torch.bfloat16, remat=False,
                          space_to_depth=False, bn_stats_every=1, groups=1,
                          base_width=64, device=None, seed=0, **kw):
    """``(model, params, {"batch_stats": ...}, loss_fn)`` for the train
    step builders with ``has_aux=True``, as the JAX package's: the aux
    carries the running statistics. Weights come from a generator
    seeded ``seed``; ``kw`` goes to :class:`ResNet` (``stage_filters``).

    ``loss_fn(params, extra, batch, rng)``: the label-smoothed softmax
    cross-entropy (``optax.smooth_labels`` then
    ``softmax_cross_entropy``, mean over the batch) of the train-mode
    logits of ``batch["image"]`` (NHWC, numpy or tensor) against
    ``batch["label"]``; returns ``(loss, {"batch_stats": updated})``.
    ``rng`` is unused (no dropout)."""
    model = ResNet(depth=depth, num_classes=num_classes, vd=vd, dtype=dtype,
                   remat=remat, space_to_depth=space_to_depth,
                   bn_stats_every=bn_stats_every, groups=groups,
                   base_width=base_width, device=device, **kw)
    dev = next(model.parameters()).device
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    params = {name: p.detach().clone()
              for name, p in model.named_parameters()}

    def loss_fn(params, extra, batch, rng):
        dev = next(iter(params.values())).device
        image = torch.as_tensor(batch["image"], device=dev)
        labels = torch.as_tensor(batch["label"], device=dev).long()
        logits, stats = functional_call(
            model, params, (image, extra["batch_stats"]), {"train": True})
        loss = F.cross_entropy(logits.float(), labels,
                               label_smoothing=label_smoothing)
        return loss, {"batch_stats": stats}

    return model, params, {"batch_stats": init_batch_stats(model)}, loss_fn


def flops_per_image(image_size=224, **model_kw):
    """Forward FLOPs of one image through ``ResNet(**model_kw)``: 2 per
    multiply-add of every conv and of the dense head, at the shapes the
    port runs them (the s2d stem as its 2x2 conv on 12 channels, zero
    taps included), read from a forward on the meta device."""
    model = ResNet(device="meta", **model_kw)
    flops = []

    def count(module, args, out):
        # multiply-adds per output: a dense's kernel is [in, out], a
        # conv's [out, in / groups, k, k]
        if isinstance(module, Dense):
            per_output = module.kernel.shape[0]
        elif isinstance(module, S2DStemConv):
            per_output = math.prod(module.s2d_kernel().shape[1:])
        else:
            per_output = math.prod(module.kernel.shape[1:])
        flops.append(2 * out.numel() * per_output)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, S2DStemConv, Dense))]
    x = torch.empty(1, image_size, image_size, 3, device="meta")
    with torch.no_grad():
        model(x, init_batch_stats(model))
    for h in hooks:
        h.remove()
    return sum(flops)


def synthetic_image_batch(batch_size, image_size=224, num_classes=1000,
                          seed=0):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randn(batch_size, image_size, image_size, 3)
                    .astype(np.float32),
        "label": rng.randint(0, num_classes, size=(batch_size,))
                    .astype(np.int32),
    }


def params_from_flax(params, batch_stats=None):
    """The port's ``(params, batch_stats)`` (flat dicts of f32 CPU
    tensors) from a flax ResNet's ``params`` and ``batch_stats`` trees
    (nested dicts of arrays). Names join the flax path with dots; conv
    kernels go from HWIO to OIHW (a grouped conv's [k, k, in/g, out]
    to [out, in/g, k, k]); dense kernels keep [in, out]."""
    def flat(tree):
        out = {}

        def walk(prefix, node):
            for key, val in node.items():
                name = "%s.%s" % (prefix, key) if prefix else str(key)
                if hasattr(val, "items"):  # dict or flax FrozenDict
                    walk(name, val)
                    continue
                arr = np.asarray(val)
                if arr.dtype.kind != "f":
                    raise TypeError("%s is %s, not floating"
                                    % (name, arr.dtype))
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                # a copy: the tree's arrays may be read-only views
                out[name] = torch.from_numpy(np.array(arr, np.float32,
                                                      order="C"))

        walk("", tree)
        return out

    return flat(params), flat(batch_stats or {})
