"""Post-training int8 quantization for the serving path.

Port of ``tsr_tpu/quant.py``. A trained judge (VGG16, plain or with batch
norm) or restorer (SimpleUNet, ResUNet) becomes an int8 module that drops
into :func:`tsr_tpu_torch.eval.make_fused_eval_step` in its place:

- weights: symmetric per-output-channel int8 (abs-max), batch norm folded
  into the preceding convolution first (inference form, running
  statistics);
- activations: symmetric per-tensor *dynamic* int8 (abs-max of the whole
  batch, computed at each call; no calibration set);
- products: int8 x int8 -> int32 through ``torch._int_mm``, then
  ``y * (sx * scale) + bias`` in float32, the activation, and the result
  stored in bf16 (the dense layers keep float32).

The four products are library calls, as the JAX package leaves them to
XLA's ``conv_general_dilated`` / ``dot_general`` / ``conv_transpose``:

- 3x3 SAME convolution: im2col (K ordered ``(kh, kw, c)``) and one product;
- 1x1 convolution: a plain product;
- ConvTranspose k=2, s=2: one product ``[B*H*W, C] x [C, 4*O]`` and a 2x2
  pixel shuffle (the windows do not overlap);
- dense: a plain product.

``F.conv2d`` on int8 returns int8 and wraps (three channels of 100 x 100
over 3x3 give -80, not 270000), so it is not used. On CUDA ``_int_mm``
takes ``a`` of more than 16 rows and a K and N that are multiples of 8:
the weights are stored zero-padded to ``[N8, K8]`` and an activation
operand is padded with zero columns (K = 27 for a first convolution) or
rows (a batch of 16 or fewer in the dense layers); padding adds zeros to
the sums and its rows and columns are sliced away. int32 cannot overflow:
the largest K is the judge's FC1 (25088), and 127^2 x 25088 ~ 4.0e8.

Inside, activations are NHWC; the modules take and return NCHW like the
float ones (the judge's features are flattened in CHW order before FC1).
A convolution runs in chunks of the batch so that one chunk's im2col
columns, int32 product and float32 temporaries stay under
:data:`MAX_PRODUCT_BYTES`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tsr_tpu_torch.models import ResUNet, SimpleUNet, VGG16

ACT_DTYPE = torch.bfloat16
BN_EPS = 1e-5
# what one chunk of a convolution may materialise: a full im2col of the
# ResUNet's dec1 at batch 512 x 224 x 224 would take 29.6 GB
MAX_PRODUCT_BYTES = 1 << 30


def _round_up(n: int, m: int = 8) -> int:
    return -(-n // m) * m


def _per_127(s: torch.Tensor) -> torch.Tensor:
    """``s / 127`` as an IEEE division on every device: CUDA divides by a
    Python number as a multiply by its float32 reciprocal, which can miss
    the quotient by an ulp (and with it the CPU's and the reference's
    scales)."""
    return s / torch.full_like(s, 127.0)


def _bn_factor(bn: nn.BatchNorm2d) -> torch.Tensor:
    """``gamma / sqrt(var + eps)`` of an inference-form batch norm, float32.
    The square root is taken in float64 and rounded once: torch's float32
    ``sqrt`` on the CPU can miss the correctly rounded result by an ulp."""
    root = (bn.running_var + BN_EPS).double().sqrt().float()
    return bn.weight.detach() / root


def absmax_quantize(w: torch.Tensor, dims) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Symmetric abs-max int8 quantization of float ``w`` over ``dims``.

    Returns ``(q, scale)``: ``q`` int8 in [-127, 127] (round half to
    even), ``scale`` float32 shaped like ``w`` reduced over ``dims``, such
    that ``q * scale ~= w``. In torch layouts the output channel is kept:
    a convolution ``[O, I, kh, kw]`` reduces over ``(1, 2, 3)``, a
    ``ConvTranspose2d`` ``[I, O, 2, 2]`` over ``(0, 2, 3)``, a ``Linear``
    ``[out, in]`` over ``1``.
    """
    s = w.abs().amax(dim=dims, keepdim=True)
    s = _per_127(s.clamp_min(1e-8).to(torch.float32))
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return q, s.squeeze(dims)


def quantize_act(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor int8 of an activation: ``(q, s)``.

    The abs-max is taken in ``h``'s dtype, floored at 1e-8, cast to
    float32 and divided by 127. The division runs on ``h`` in float32: a
    0-dim float32 tensor takes no part in torch's type promotion, so a
    bf16 ``h / s`` would divide in bf16 where JAX promotes to float32.
    """
    lo, hi = torch.aminmax(h)
    s = _per_127(torch.maximum(-lo, hi).clamp_min(1e-8).to(torch.float32))
    x = h.to(torch.float32, copy=True)
    return x.div_(s).round_().clamp_(-127, 127).to(torch.int8), s


class QuantizedLayer(nn.Module):
    """An int8 convolution or dense layer: ``q`` int8 ``[N8, K8]`` (the
    product's weight matrix, zero-padded to multiples of 8), ``scale`` and
    ``bias`` float32 per output channel.

    ``kind`` is ``"3x3"`` (K ordered ``(kh, kw, c)``), ``"1x1"``,
    ``"t2x2"`` (rows ordered ``(a, b, o)`` for output pixel ``(2y + a,
    2x + b)``, so N = 4 x out_channels) or ``"dense"``.
    """

    def __init__(self, kind: str, q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.kind = kind
        self.n, self.k = q.shape
        self.out_channels = scale.numel()
        self.register_buffer("q", F.pad(q, (0, _round_up(self.k) - self.k,
                                            0, _round_up(self.n) - self.n)))
        self.register_buffer("scale", scale.to(torch.float32))
        self.register_buffer("bias", bias.detach().to(torch.float32,
                                                      copy=True))

    @classmethod
    def conv(cls, weight: torch.Tensor, bias: torch.Tensor
             ) -> "QuantizedLayer":
        """From a float ``[O, I, kh, kw]`` weight (3x3 or 1x1)."""
        q, s = absmax_quantize(weight, (1, 2, 3))
        kind = "3x3" if weight.shape[-1] == 3 else "1x1"
        return cls(kind, q.permute(0, 2, 3, 1).reshape(q.shape[0], -1), s,
                   bias)

    @classmethod
    def conv_transpose(cls, weight: torch.Tensor, bias: torch.Tensor
                       ) -> "QuantizedLayer":
        """From a float ``ConvTranspose2d`` weight ``[I, O, 2, 2]``."""
        q, s = absmax_quantize(weight, (0, 2, 3))
        return cls("t2x2", q.permute(2, 3, 1, 0).reshape(-1, q.shape[0]), s,
                   bias)

    @classmethod
    def dense(cls, weight: torch.Tensor, bias: torch.Tensor
              ) -> "QuantizedLayer":
        """From a float ``Linear`` weight ``[out, in]``."""
        q, s = absmax_quantize(weight, (1,))
        return cls("dense", q, s, bias)


def _pad_hw(xq: torch.Tensor) -> torch.Tensor:
    """SAME padding of an NHWC int8 activation for a 3x3 window."""
    return F.pad(xq, (0, 0, 1, 1, 1, 1))


def _columns(x: torch.Tensor, layer: QuantizedLayer, h: int, w: int
             ) -> torch.Tensor:
    """The product's int8 left operand ``[b*h*w, K8]`` for a chunk ``x``
    of the activation (padded by :func:`_pad_hw` for a 3x3 window)."""
    b, c = x.shape[0], x.shape[-1]
    k8 = layer.q.shape[1]
    if layer.kind != "3x3":
        return _pad_operand(x.reshape(b * h * w, c), k8)
    parts = [x[:, dy:dy + h, dx:dx + w] for dy in range(3)
             for dx in range(3)]
    if k8 > 9 * c:
        parts.append(x.new_zeros((b, h, w, k8 - 9 * c)))
    return _pad_operand(torch.cat(parts, dim=-1).view(b * h * w, k8), k8)


def _pad_operand(a: torch.Tensor, k8: int) -> torch.Tensor:
    """Zero columns up to ``k8`` and zero rows up to 17 (``_int_mm``'s
    least row count on CUDA is 17)."""
    m, k = a.shape
    if k == k8 and m > 16:
        return a.contiguous()
    return F.pad(a, (0, k8 - k, 0, max(0, 17 - m)))


def _int8_product(a: torch.Tensor, layer: QuantizedLayer, rows: int
                  ) -> torch.Tensor:
    """int8 ``a [>= rows, K8]`` x ``layer.q.T`` -> int32 ``[rows, n]``."""
    return torch._int_mm(a, layer.q.t())[:rows, :layer.n]


def _dequantize(y: torch.Tensor, sx: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, relu: bool, store) -> torch.Tensor:
    """``y * (sx * scale) + bias`` in float32, then ReLU, stored as
    ``store`` (bf16, or float32 for the dense layers)."""
    h = y.to(torch.float32).mul_(sx * scale).add_(bias)
    if relu:
        h = h.relu_()
    return h.to(store)


def _conv(qx: Tuple[torch.Tensor, torch.Tensor], layer: QuantizedLayer,
          relu: bool) -> torch.Tensor:
    """An int8 convolution (3x3 SAME, 1x1 or ConvTranspose 2x2/2) of the
    quantized NHWC activation ``qx = (q, s)``; returns NHWC bf16."""
    xq, sx = qx
    b, h, w, _ = xq.shape
    if layer.kind == "3x3":
        xq = _pad_hw(xq)
    up = 2 if layer.kind == "t2x2" else 1
    scale, bias = layer.scale, layer.bias
    if up == 2:
        scale, bias = scale.repeat(4), bias.repeat(4)
    o = layer.out_channels
    row_bytes = layer.q.shape[1] + 12 * layer.q.shape[0]
    chunk = max(1, MAX_PRODUCT_BYTES // (h * w * row_bytes))
    out = None
    for i in range(0, b, chunk):
        x = xq[i:i + chunk]
        rows = x.shape[0] * h * w
        y = _int8_product(_columns(x, layer, h, w), layer, rows)
        part = _dequantize(y, sx, scale, bias, relu, ACT_DTYPE)
        if up == 2:
            part = part.view(-1, h, w, 2, 2, o).permute(0, 1, 3, 2, 4, 5)
        part = part.reshape(-1, h * up, w * up, o)
        if chunk >= b:
            return part
        if out is None:
            out = xq.new_empty((b, h * up, w * up, o), dtype=ACT_DTYPE)
        out[i:i + chunk] = part
    return out


def _dense(h: torch.Tensor, layer: QuantizedLayer, relu: bool
           ) -> torch.Tensor:
    """An int8 dense layer on ``[B, F]``; returns float32."""
    xq, sx = quantize_act(h)
    y = _int8_product(_pad_operand(xq, layer.q.shape[1]), layer, len(h))
    return _dequantize(y, sx, layer.scale, layer.bias, relu, torch.float32)


def _maxpool2(h: torch.Tensor) -> torch.Tensor:
    """2x2 / 2 max pooling of an NHWC activation, in its dtype."""
    b, hh, ww, c = h.shape
    return h.view(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


def _prelu(h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with the slope cast to the activation's dtype (so a bf16
    activation stays bf16)."""
    return torch.where(h >= 0, h, alpha.to(h.dtype) * h)


def _residual(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (y + s).relu_()


def _nhwc_input(x: torch.Tensor) -> torch.Tensor:
    """NCHW float input -> NHWC float32."""
    return x.permute(0, 2, 3, 1).to(torch.float32)


def _check_divisible(x: torch.Tensor, levels: int, name: str) -> None:
    div = 2 ** levels
    if x.shape[2] % div or x.shape[3] % div:
        raise ValueError(f"{name} needs H and W divisible by {div}, "
                         f"got {tuple(x.shape)}")


# ------------------------------------------------------------------- judge

def fold_batchnorm_vgg(judge: VGG16) -> Dict[str, Dict[str, torch.Tensor]]:
    """Batch norm (inference form) of a vgg16_bn judge folded into each
    preceding convolution:

        y = gamma * (conv(x) + b - mean) / sqrt(var + eps) + beta
          = conv(x) * g + (b - mean) * g + beta,   g = gamma / sqrt(var + eps)

    Returns ``{name: {"weight", "bias"}}`` float32 for every convolution
    (``features.N``, the variant's own indices) and the three ``Linear``
    layers (``classifier.0/3/6``); a plain judge's as they are.
    """
    out = {}
    layers = list(judge.features)
    for i, m in enumerate(layers):
        if not isinstance(m, nn.Conv2d):
            continue
        w, b = m.weight.detach(), m.bias.detach()
        bn = layers[i + 1]
        if isinstance(bn, nn.BatchNorm2d):
            g = _bn_factor(bn)
            w = w * g[:, None, None, None]
            b = (b - bn.running_mean) * g + bn.bias.detach()
        out[f"features.{i}"] = {"weight": w, "bias": b}
    for i in (0, 3, 6):
        fc = judge.classifier[i]
        out[f"classifier.{i}"] = {"weight": fc.weight.detach(),
                                  "bias": fc.bias.detach()}
    return out


class Int8VGG16(nn.Module):
    """The int8 judge: ``forward(x)`` takes the float judge's input
    (ImageNet-normalized NCHW) and returns float32 logits. Max pooling runs
    on the bf16 activations; FC1 reads the features in CHW order."""

    def __init__(self, judge: VGG16):
        super().__init__()
        folded = fold_batchnorm_vgg(judge)
        self.cfg = judge.cfg
        self.convs = nn.ModuleList(
            QuantizedLayer.conv(**p) for name, p in folded.items()
            if name.startswith("features."))
        self.fcs = nn.ModuleList(
            QuantizedLayer.dense(**folded[f"classifier.{i}"])
            for i in (0, 3, 6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _nhwc_input(x)
        convs = iter(self.convs)
        for v in self.cfg:
            if v == "M":
                h = _maxpool2(h)
            else:
                h = _conv(quantize_act(h), next(convs), relu=True)
        h = h.permute(0, 3, 1, 2).reshape(len(h), -1)
        h = _dense(h, self.fcs[0], relu=True)
        h = _dense(h, self.fcs[1], relu=True)
        return _dense(h, self.fcs[2], relu=False)


def quantize_vgg16(judge: VGG16) -> Int8VGG16:
    """The int8 serving form of a trained VGG16 (plain or batch norm,
    folded first), on the judge's device."""
    with torch.no_grad():
        return Int8VGG16(judge)


def quantized_judge(judge: VGG16) -> Int8VGG16:
    """The int8 drop-in for ``make_fused_eval_step``'s judge."""
    return quantize_vgg16(judge)


# --------------------------------------------------------------- restorers

def _ups(model: nn.Module, n: int) -> nn.ModuleList:
    """A U-Net's ``up1`` .. ``up{n}`` ConvTranspose layers, quantized."""
    return nn.ModuleList(
        QuantizedLayer.conv_transpose(getattr(model, f"up{i + 1}").weight,
                                      getattr(model, f"up{i + 1}").bias)
        for i in range(n))


def _double_conv(dc: nn.Sequential) -> nn.ModuleList:
    return nn.ModuleList(QuantizedLayer.conv(dc[i].weight, dc[i].bias)
                         for i in (0, 2))


class Int8SimpleUNet(nn.Module):
    """The int8 SimpleUNet: ``forward(x)`` takes float NCHW in [0, 1] and
    returns bf16 NCHW. The ``input_minmax`` stretch stays float32; each
    ``DoubleConv`` has a ReLU after both convolutions; the decoder output
    comes first in each skip concat."""

    def __init__(self, model: SimpleUNet):
        super().__init__()
        n = len(model.widths)
        self.input_minmax = model.input_minmax
        self.encs = nn.ModuleList(_double_conv(getattr(model, f"enc{i + 1}"))
                                  for i in range(n))
        self.bottleneck = _double_conv(model.bottleneck)
        self.ups = _ups(model, n)
        self.decs = nn.ModuleList(_double_conv(getattr(model, f"dec{i + 1}"))
                                  for i in range(n))
        self.final = QuantizedLayer.conv(model.final.weight, model.final.bias)

    @staticmethod
    def _dc(h, convs):
        h = _conv(quantize_act(h), convs[0], relu=True)
        return _conv(quantize_act(h), convs[1], relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.encs)
        _check_divisible(x, n, "SimpleUNet")
        h = _nhwc_input(x)
        if self.input_minmax:
            lo = h.amin(dim=(1, 2, 3), keepdim=True)
            hi = h.amax(dim=(1, 2, 3), keepdim=True)
            h = (h - lo) / (hi - lo).clamp_min(1e-6)
        skips = []
        for i in range(n):
            h = self._dc(h, self.encs[i])
            skips.append(h)
            h = _maxpool2(h)
        h = self._dc(h, self.bottleneck)
        for i in reversed(range(n)):
            h = _conv(quantize_act(h), self.ups[i], relu=False)
            h = self._dc(torch.cat((h, skips[i]), dim=-1), self.decs[i])
        return _conv(quantize_act(h), self.final,
                     relu=False).permute(0, 3, 1, 2)


def _fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d
                  ) -> Dict[str, torch.Tensor]:
    """Inference-form batch norm folded into the preceding convolution."""
    g = _bn_factor(bn)
    return {"weight": conv.weight * g[:, None, None, None],
            "bias": (conv.bias - bn.running_mean) * g + bn.bias}


class _Int8Block(nn.Module):
    """A ResUNet ``ResidualBlock`` with its batch norms folded."""

    def __init__(self, block: nn.Module):
        super().__init__()
        cb = block.conv_block
        self.conv1 = QuantizedLayer.conv(**_fold_conv_bn(cb[0], cb[1]))
        self.register_buffer("alpha", cb[2].weight.detach().clone())
        self.conv2 = QuantizedLayer.conv(**_fold_conv_bn(cb[3], cb[4]))
        self.shortcut = (QuantizedLayer.conv(**_fold_conv_bn(
            block.shortcut[0], block.shortcut[1]))
            if len(block.shortcut) else None)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        qh = quantize_act(h)
        y = _prelu(_conv(qh, self.conv1, relu=False), self.alpha)
        y = _conv(quantize_act(y), self.conv2, relu=False)
        s = h if self.shortcut is None else _conv(qh, self.shortcut,
                                                  relu=False)
        return _residual(y, s)


class Int8ResUNet(nn.Module):
    """The int8 ResUNet: ``forward(x)`` takes float NCHW in [0, 1] and
    returns bf16 NCHW. Each block ends with ``relu(y + s)`` in bf16; the
    PReLU slopes are cast to the activation's dtype."""

    def __init__(self, model: ResUNet):
        super().__init__()
        n = len(model.widths)
        self.stem = QuantizedLayer.conv(model.enc1[0].weight,
                                        model.enc1[0].bias)
        self.register_buffer("stem_alpha",
                             model.enc1[1].weight.detach().clone())
        self.encs = nn.ModuleList(_Int8Block(getattr(model, f"res{i + 1}"))
                                  for i in range(n))
        self.bottlenecks = nn.ModuleList(_Int8Block(b)
                                         for b in model.bottleneck)
        self.ups = _ups(model, n)
        self.decs = nn.ModuleList(_Int8Block(getattr(model, f"dec{i + 1}"))
                                  for i in range(n))
        self.final = QuantizedLayer.conv(model.final.weight, model.final.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.encs)
        _check_divisible(x, n, "ResUNet")
        h = _conv(quantize_act(_nhwc_input(x)), self.stem, relu=False)
        h = _prelu(h, self.stem_alpha)
        skips = []
        for i in range(n):
            h = self.encs[i](h)
            skips.append(h)
            h = _maxpool2(h)
        for block in self.bottlenecks:
            h = block(h)
        for i in reversed(range(n)):
            h = _conv(quantize_act(h), self.ups[i], relu=False)
            h = self.decs[i](torch.cat((h, skips[i]), dim=-1))
        return _conv(quantize_act(h), self.final,
                     relu=False).permute(0, 3, 1, 2)


def quantize_simple_unet(model: SimpleUNet) -> Int8SimpleUNet:
    """The int8 serving form of a trained SimpleUNet, on its device."""
    with torch.no_grad():
        return Int8SimpleUNet(model)


def quantize_resunet(model: ResUNet) -> Int8ResUNet:
    """The int8 serving form of a trained ResUNet (batch norms folded from
    the running statistics), on its device."""
    with torch.no_grad():
        return Int8ResUNet(model)


def quantized_restorer(model: nn.Module) -> nn.Module:
    """The int8 drop-in for ``make_fused_eval_step``'s restorer, by the
    model's class. It returns bf16, as the reference's does: the fused
    step's clamp then runs in bf16."""
    if isinstance(model, SimpleUNet):
        return quantize_simple_unet(model)
    if isinstance(model, ResUNet):
        return quantize_resunet(model)
    raise TypeError(f"no int8 form for {type(model).__name__}")
