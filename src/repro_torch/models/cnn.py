"""The paper's own vision models: the small CNN (Example 3) and ResNet-20
(Example 4) (port of `repro.models.cnn`).

Params are plain dicts and lists of tensors with the JAX package's leaf
shapes: HWIO convolution weights and ResNet-20's ``blocks`` as a list, so
`repro_torch.tree` lists the leaves in JAX's order (per-leaf masks,
``p_leaf`` and Eq.-(8) sizes are indexed by it).  Activations are NHWC as
in JAX; a convolution views them as NCHW in channels-last memory (no copy)
and permutes the stored HWIO weight in the forward pass only.

Three details keep the port on the reference's numbers:

  * SAME padding is split as XLA splits it, low = total // 2 and high =
    the rest, so a stride-2 3x3 conv on an even size pads (0, 1), where a
    symmetric ``padding=1`` would shift every output pixel;
  * the max pool is a SAME window padded with -inf, as
    ``reduce_window(-inf, max)`` is;
  * convolutions run in IEEE fp32 in the forward and the backward pass:
    cuDNN allows TF32 by default, which rounds the operands to 10 mantissa
    bits.  The pin is scoped to each convolution (`_Conv2dIEEE`), not set
    for the process.

The same scope pins cuDNN's deterministic algorithms with its autotuner
off: cuDNN's default backward algorithms sum the weight gradient in an
order that changes from run to run, so two runs from one seed drifted
apart on the card.  With the pin they repeat bit for bit, as JAX's do, and
nothing stays switched after a convolution returns.

BatchNorm is GroupNorm, as in the reference (BN's running statistics break
under non-IID data).
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

__all__ = ["cnn_init", "cnn_apply", "resnet20_init", "resnet20_apply", "ce_loss"]


@contextlib.contextmanager
def _ieee_fp32():
    """cuDNN convolutions in IEEE fp32 (TF32 off), with deterministic
    algorithms and the autotuner off, inside the block; the three flags
    are what they were after it."""
    cudnn = torch.backends.cudnn
    prev = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = False, True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = prev


class _Conv2dIEEE(torch.autograd.Function):
    """An unpadded ``F.conv2d`` whose forward and backward both run under
    `_ieee_fp32` (autograd runs the backward after the forward's scope has
    closed, so a pin around the forward alone would not reach it)."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _ieee_fp32():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _ieee_fp32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [ctx.stride] * 2, [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
            )
        return gx, gw, None


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME split for one spatial dim: (low, high)."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_init(gen, kh, kw, cin, cout, device=None):
    fan = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=gen, device=device) * (2.0 / fan) ** 0.5


def _conv(x, w, stride=1):
    """SAME convolution, NHWC input and HWIO weight (``conv_general_dilated``
    with ("NHWC", "HWIO", "NHWC")), NHWC out."""
    kh, kw = w.shape[0], w.shape[1]
    ph, pw = _same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = _Conv2dIEEE.apply(xc, w.permute(3, 2, 0, 1).contiguous(), stride)
    return y.permute(0, 2, 3, 1)


def _group_norm(x, scale, bias, groups=8, eps=1e-5):
    """GroupNorm over g = min(groups, c) groups of contiguous channels,
    biased variance, eps inside the rsqrt; NHWC in and out."""
    c = x.shape[-1]
    y = F.group_norm(x.permute(0, 3, 1, 2), min(groups, c), scale, bias, eps)
    return y.permute(0, 2, 3, 1)


def _pool(x):
    """2x2 max pool, stride 2, SAME with -inf padding (NHWC)."""
    ph, pw = _same_pads(x.shape[1], 2, 2), _same_pads(x.shape[2], 2, 2)
    xc = x.permute(0, 3, 1, 2)
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]), value=-math.inf)
    return F.max_pool2d(xc, 2, 2).permute(0, 2, 3, 1)


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


# ---------------------------------------------------------------------------
# Example 3 CNN: conv32-pool-conv64-pool-fc
# ---------------------------------------------------------------------------
def cnn_init(seed: int = 0, in_ch: int = 1, n_classes: int = 10, width: int = 1,
             device=None) -> dict:
    """`width` multiplies every channel/feature count (width=1 is the
    paper's Example 3; width=2 crosses 1M parameters).  `cnn_apply` reads
    all shapes from the params.  The weights are drawn from a
    ``torch.Generator`` seeded with `seed`, at the reference's shapes and
    scales (its values come across with `repro_torch.convert.to_torch`)."""
    g = _gen(seed, device)
    c1, c2, hid = 32 * width, 64 * width, 128 * width
    return {
        "c1": _conv_init(g, 3, 3, in_ch, c1, device),
        "c2": _conv_init(g, 3, 3, c1, c2, device),
        "fc1": torch.randn((7 * 7 * c2, hid), generator=g, device=device) * (7 * 7 * c2) ** -0.5,
        "b1": torch.zeros((hid,), device=device),
        "fc2": torch.randn((hid, n_classes), generator=g, device=device) * hid ** -0.5,
        "b2": torch.zeros((n_classes,), device=device),
    }


def cnn_apply(params: dict, images: torch.Tensor) -> torch.Tensor:
    """Logits [N, classes] of NHWC images."""
    x = F.relu(_conv(images, params["c1"]))
    x = _pool(x)
    x = F.relu(_conv(x, params["c2"]))
    x = _pool(x)
    x = x.reshape(x.shape[0], -1)  # NHWC order (h, w, c), as fc1's rows are
    x = F.relu(x @ params["fc1"] + params["b1"])
    return x @ params["fc2"] + params["b2"]


# ---------------------------------------------------------------------------
# Example 4 ResNet-20 (CIFAR variant; widths 16/32/64, GN instead of BN)
# ---------------------------------------------------------------------------
def resnet20_init(seed: int = 0, in_ch: int = 3, n_classes: int = 10, device=None) -> dict:
    g = _gen(seed, device)
    params = {"stem": _conv_init(g, 3, 3, in_ch, 16, device),
              "stem_s": torch.ones((16,), device=device),
              "stem_b": torch.zeros((16,), device=device)}
    blocks: List[dict] = []
    cin = 16
    for si, w in enumerate((16, 32, 64)):
        for bi in range(3):
            blk = {
                "c1": _conv_init(g, 3, 3, cin, w, device),
                "s1": torch.ones((w,), device=device), "b1": torch.zeros((w,), device=device),
                "c2": _conv_init(g, 3, 3, w, w, device),
                "s2": torch.ones((w,), device=device), "b2": torch.zeros((w,), device=device),
            }
            if _block_stride(si, bi) != 1 or cin != w:
                blk["proj"] = _conv_init(g, 1, 1, cin, w, device)
            blocks.append(blk)
            cin = w
    params["blocks"] = blocks
    params["fc"] = torch.randn((64, n_classes), generator=g, device=device) * 64 ** -0.5
    params["fc_b"] = torch.zeros((n_classes,), device=device)
    return params


def _block_stride(stage: int, block: int) -> int:
    return 2 if (stage > 0 and block == 0) else 1


def resnet20_apply(params: dict, images: torch.Tensor) -> torch.Tensor:
    x = F.relu(_group_norm(_conv(images, params["stem"]), params["stem_s"], params["stem_b"]))
    for idx, blk in enumerate(params["blocks"]):
        stride = _block_stride(idx // 3, idx % 3)
        h = F.relu(_group_norm(_conv(x, blk["c1"], stride), blk["s1"], blk["b1"]))
        h = _group_norm(_conv(h, blk["c2"]), blk["s2"], blk["b2"])
        sc = _conv(x, blk["proj"], stride) if "proj" in blk else x
        x = F.relu(h + sc)
    x = x.mean(dim=(1, 2))
    return x @ params["fc"] + params["fc_b"]


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; `labels` int32 as the batcher serves them (cast
    to int64 only for the gather)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)

