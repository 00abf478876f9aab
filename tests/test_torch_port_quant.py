"""The port's int8 serving path (``tsr_tpu_torch.quant``) against
``tsr_tpu.quant`` on the CPU: the weight and activation quantizers, every
layer's quantized tensors (plain and batch-norm judge, SimpleUNet with and
without ``input_minmax``, ResUNet), the int8 forwards, the padding that
``torch._int_mm`` needs on the card, ``tests/test_quant.py``'s accuracy
bounds on the port's own float models, and the fused-step drop-in.

Sizes are ``tests/test_quant.py``'s: a judge of ``cfg=(8, "M", 16, "M")``
and FC 32 at 32x32, SimpleUNet (8, 16), ResUNet (8, 16, 24) / 32. Weights
come from the reference's init through ``checkpoint.*_from_jax``; inputs
are made with numpy and handed to both sides.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsr_tpu import eval as jeval
from tsr_tpu import quant as jquant
from tsr_tpu.models import ResUNet as JResUNet
from tsr_tpu.models import SimpleUNet as JSimpleUNet
from tsr_tpu.models import VGG16 as JVGG16
from tsr_tpu_torch import checkpoint, quant
from tsr_tpu_torch import eval as teval
from tsr_tpu_torch.models import ResUNet, SimpleUNet, VGG16
from tsr_tpu_torch.ops import image as timage

torch.set_num_threads(2)
TINY_CFG = (8, "M", 16, "M")
SIZE = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _nchw_view(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def _perturb(tree, rng, lo, hi, only_vectors=False):
    """Each leaf (each vector with ``only_vectors``) plus uniform [lo, hi):
    non-trivial batch-norm statistics and affine parameters, so the fold
    is not an identity (as ``tests/test_quant.py`` does)."""
    return jax.tree.map(
        lambda a: a + rng.uniform(lo, hi, np.shape(a)).astype(np.float32)
        if not only_vectors or np.ndim(a) == 1 else a, tree)


def _init(jm, **kw):
    """The reference's init (jitted: one compile instead of one per op),
    as numpy."""
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, SIZE, SIZE, 3)),
                                       **kw))
    return jax.tree.map(np.array, init(jax.random.PRNGKey(0)))


def _judges(use_batchnorm=False, num_classes=7):
    jm = JVGG16(num_classes=num_classes, cfg=TINY_CFG, fc_width=32,
                use_batchnorm=use_batchnorm)
    jv = _init(jm)
    if use_batchnorm:
        jv = _perturb(jv, np.random.default_rng(2), 0.1, 0.5,
                      only_vectors=True)
    tm = VGG16(num_classes=num_classes, cfg=TINY_CFG, fc_width=32,
               input_size=SIZE, use_batchnorm=use_batchnorm)
    tm.load_state_dict(checkpoint.vgg16_from_jax(jv))
    return jm, jv, tm.eval()


def _resunets():
    jm = JResUNet(widths=(8, 16, 24), bottleneck_width=32)
    v = _init(jm, train=True)
    jv = jax.tree.map(np.array, {
        "params": v["params"],
        "batch_stats": _perturb(v["batch_stats"],
                                np.random.default_rng(4), 0.05, 0.3)})
    tm = ResUNet((8, 16, 24), 32)
    tm.load_state_dict(checkpoint.resunet_from_jax(jv))
    return jm, jv, tm.eval()


def _unets(input_minmax=False):
    jm = JSimpleUNet(widths=(8, 16), input_minmax=input_minmax)
    jv = _init(jm)
    tm = SimpleUNet((8, 16), input_minmax=input_minmax)
    tm.load_state_dict(checkpoint.simple_unet_from_jax(jv))
    return jm, jv, tm.eval()


@pytest.fixture(scope="module")
def resunets():
    return _resunets()


def _logit_agreement(a, b):
    """(pearson corr over all logits, top-1 agreement fraction)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.corrcoef(a.ravel(), b.ravel())[0, 1],
            float(np.mean(a.argmax(-1) == b.argmax(-1))))


def _rel_err(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.sqrt(np.mean((ref - got) ** 2)) / (np.std(ref) + 1e-12))


# ------------------------------------------------------------- quantizers

@pytest.mark.parametrize("layout", ["conv", "conv_transpose", "linear"])
def test_absmax_quantize_matches_jax(layout):
    """absmax_quantize on each torch layout (the output channel kept: dims
    (1, 2, 3), (0, 2, 3), 1) equals tsr_tpu's on the same values in the
    reference's layout: int8 q and float32 scale exactly; |q| reaches 127
    and q * scale is within half a step of w."""
    rng = np.random.default_rng(0)
    shapes = {"conv": ((16, 8, 3, 3), (2, 3, 1, 0), (1, 2, 3), (0, 1, 2)),
              "conv_transpose": ((8, 16, 2, 2), (2, 3, 0, 1), (0, 2, 3),
                                 (0, 1, 2)),
              "linear": ((16, 40), (1, 0), (1,), (0,))}
    shape, perm, dims, jaxes = shapes[layout]
    w = rng.normal(0, 0.3, shape).astype(np.float32)
    q, s = quant.absmax_quantize(_t(w), dims)
    jq, js = jquant.absmax_quantize(jnp.asarray(w.transpose(perm)), jaxes)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (16,) and np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(q.numpy().transpose(perm), np.asarray(jq))
    assert int(q.abs().max()) == 127
    bshape = [16 if i not in dims else 1 for i in range(len(shape))]
    err = (q.float() * s.reshape(bshape) - _t(w)).abs()
    assert (err <= s.reshape(bshape) * 0.5 + 1e-7).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_quantize_act_matches_jax_and_divides_in_float32(dtype):
    """quantize_act equals tsr_tpu's _quantize_act (q and s exactly) on a
    float32 and a bf16 activation. For bf16 the case is one where dividing
    in bf16 (torch's promotion with a 0-dim float32 scale) gives other
    integers on many values, so a division left in bf16 fails it."""
    h = np.random.default_rng(1).normal(0, 1.5, (4, 8, 8, 16))
    th = _t(h.astype(np.float32)).to(dtype)
    jh = jnp.asarray(th.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    q, s = quant.quantize_act(th)
    jq, js = jquant._quantize_act(jh)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0
    assert s.item() == float(js)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    if dtype == torch.bfloat16:
        in_bf16 = torch.round(th / s).clamp(-127, 127).to(torch.int8)
        assert (th / s).dtype == torch.bfloat16
        assert (in_bf16 != q).float().mean() > 0.05
    zeros = torch.zeros(2, 3, dtype=dtype)
    zq, zs = quant.quantize_act(zeros)
    jzq, jzs = jquant._quantize_act(jnp.zeros((2, 3), jh.dtype))
    assert zs.item() == float(jzs) and not zq.any()


@pytest.mark.parametrize("case", ["k27-first-conv", "n3-final-1x1",
                                  "n43-head", "batch8-dense"])
def test_int_mm_padding_equals_int64_product(case):
    """The products whose shapes _int_mm refuses on the card unpadded: a
    first 3x3 convolution (K = 27, padded to 32), a restorer's final 1x1
    (N = 3 -> 8), the 43-class head (N = 43 -> 48) and a batch of 8
    reaching the dense layers (8 rows -> 17): each equals the int64
    product of the unpadded int8 operands, extreme values included."""
    rng = np.random.default_rng(3)
    m, k, n, kind = {"k27-first-conv": (2 * 32 * 32, 27, 16, "3x3"),
                     "n3-final-1x1": (2 * 32 * 32, 64, 3, "1x1"),
                     "n43-head": (40, 4096, 43, "dense"),
                     "batch8-dense": (8, 1024, 32, "dense")}[case]
    a = _t(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = _t(rng.integers(-127, 128, (n, k)).astype(np.int8))
    a[0], w[0] = 127, -127
    layer = quant.QuantizedLayer(kind, w, torch.ones(n), torch.zeros(n))
    assert layer.q.shape == (-(-n // 8) * 8, -(-k // 8) * 8)
    operand = quant._pad_operand(a, layer.q.shape[1])
    assert operand.shape[0] >= 17 and operand.shape[1] % 8 == 0
    got = quant._int8_product(operand, layer, m)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.long(), a.long() @ w.long().t())
    assert got[0, 0].item() == -127 * 127 * k


# ------------------------------------------------------- quantized tensors

def _jax_conv_q(layer):
    """A port conv layer's int8 weight in the reference's HWIO layout."""
    n, k = layer.n, layer.k
    side = 3 if layer.kind == "3x3" else 1
    q = layer.q[:n, :k].reshape(n, side, side, k // side ** 2)
    return q.permute(1, 2, 3, 0).numpy()


def _jax_conv_t_q(layer):
    """A port ConvTranspose layer's int8 weight as the reference's
    ``[kh, kw, in, out]`` kernel (spatially mirrored against torch's)."""
    o = layer.out_channels
    q = layer.q[:layer.n, :layer.k].reshape(2, 2, o, layer.k)
    return q.permute(0, 1, 3, 2).flip(0, 1).numpy()


def _assert_layer(layer, ref):
    if layer.kind == "dense":
        q = layer.q[:layer.n, :layer.k].t().numpy()
    elif layer.kind == "t2x2":
        q = _jax_conv_t_q(layer)
    else:
        q = _jax_conv_q(layer)
    assert np.array_equal(q, np.asarray(ref["q"]))
    assert np.array_equal(layer.scale.numpy(), np.asarray(ref["scale"]))
    assert np.array_equal(layer.bias.numpy(), np.asarray(ref["bias"]))
    assert not layer.q[layer.n:].any() and not layer.q[:, layer.k:].any()


@pytest.mark.parametrize("use_batchnorm", [False, True], ids=["plain", "bn"])
def test_quantized_judge_tensors_match_jax(use_batchnorm):
    """Every layer of quantize_vgg16 (batch norm folded for the bn judge)
    equals tsr_tpu's quantize_vgg16 after the layout transpose: q, scale
    and the folded bias exactly, and the padding is zeros. The folded
    float weights equal fold_batchnorm_vgg's."""
    jm, jv, tm = _judges(use_batchnorm)
    ref = jquant.quantize_vgg16(jm, jv)
    q = quant.quantize_vgg16(tm)
    assert len(q.convs) == len(ref["convs"]) == 2 and len(q.fcs) == 3
    for layer, r in zip(list(q.convs) + list(q.fcs),
                        ref["convs"] + ref["fcs"]):
        _assert_layer(layer, r)
    jfold = jquant.fold_batchnorm_vgg(jm, jv)["params"]
    fold = quant.fold_batchnorm_vgg(tm)
    assert set(fold) == {k.replace("_", ".") for k in jfold}
    for name, p in fold.items():
        r = jfold[name.replace(".", "_")]
        w = p["weight"].numpy()
        w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
        assert np.array_equal(w, np.asarray(r["kernel"])), name
        assert np.array_equal(p["bias"].numpy(), np.asarray(r["bias"])), name


@pytest.mark.parametrize("model", ["simple_unet", "resunet"])
def test_quantized_restorer_tensors_match_jax(model, resunets):
    """Every layer of the quantized SimpleUNet and ResUNet (batch norms
    folded into conv1, conv2 and the shortcut) equals tsr_tpu's tree after
    the layout transpose; the PReLU slopes are carried over."""
    if model == "simple_unet":
        jm, jv, tm = _unets()
        ref = jquant.quantize_simple_unet(jm, jv)
        q = quant.quantize_simple_unet(tm)
        pairs = [(q.final, ref["final"])]
        for port, jax_ in (("encs", "encs"), ("decs", "decs")):
            for dc, r in zip(getattr(q, port), ref[jax_]):
                pairs += [(dc[0], r["conv1"]), (dc[1], r["conv2"])]
        pairs += [(q.bottleneck[0], ref["bottleneck"]["conv1"]),
                  (q.bottleneck[1], ref["bottleneck"]["conv2"])]
    else:
        jm, jv, tm = resunets
        ref = jquant.quantize_resunet(jm, jv)
        q = quant.quantize_resunet(tm)
        pairs = [(q.stem, ref["stem"]), (q.final, ref["final"])]
        assert q.stem_alpha.item() == float(ref["stem_alpha"])
        blocks = [b for k in ("encs", "bottlenecks", "decs")
                  for b in zip(getattr(q, k), ref[k])]
        assert len(blocks) == 9
        for b, r in blocks:
            pairs += [(b.conv1, r["conv1"]), (b.conv2, r["conv2"])]
            assert (b.shortcut is None) == ("shortcut" not in r)
            if b.shortcut is not None:
                pairs.append((b.shortcut, r["shortcut"]))
            assert b.alpha.item() == float(r["alpha"])
    pairs += list(zip(q.ups, ref["ups"]))
    for layer, r in pairs:
        _assert_layer(layer, r)


# ---------------------------------------------------------------- forwards

@pytest.mark.parametrize("use_batchnorm", [False, True], ids=["plain", "bn"])
def test_int8_judge_matches_jax_and_fp(use_batchnorm):
    """The int8 judge's float32 logits equal tsr_tpu's un-jitted int8
    forward bit for bit, and for the plain judge its jitted forward too
    (for the batch-norm judge the jitted reference differs from its own
    un-jitted one by up to 1.2e-7 here: ROADMAP section C). Against the
    port's own float judge it meets tests/test_quant.py's bounds:
    correlation > 0.995 and top-1 agreement >= 0.875 (plain, 16 images),
    > 0.99 and >= 0.8 (batch norm, 12 images)."""
    jm, jv, tm = _judges(use_batchnorm, num_classes=5 if use_batchnorm
                         else 7)
    n = 12 if use_batchnorm else 16
    x = np.random.default_rng(2 if use_batchnorm else 1).uniform(
        -2, 2, (n, SIZE, SIZE, 3)).astype(np.float32)
    apply_q, qvars = jquant.quantized_judge(jm, jv)
    q = quant.quantized_judge(tm)
    with torch.no_grad():
        got = q(_nchw(x))
        fp = tm(_nchw(x)).numpy()
    assert got.dtype == torch.float32 and got.shape == (n, tm.classifier[6]
                                                        .out_features)
    assert np.array_equal(got.numpy(), np.asarray(apply_q(qvars, x)))
    if not use_batchnorm:
        assert np.array_equal(got.numpy(),
                              np.asarray(jax.jit(apply_q)(qvars, x)))
    corr, top1 = _logit_agreement(fp, got.numpy())
    assert corr > (0.99 if use_batchnorm else 0.995), corr
    assert top1 >= (0.8 if use_batchnorm else 0.875), top1


def test_int8_resunet_matches_jax_and_fp(resunets):
    """The int8 ResUNet (batch norms folded from perturbed statistics)
    returns bf16 equal to tsr_tpu's un-jitted int8 forward bit for bit
    (its jitted forward differs from the un-jitted one by up to 0.0039 on
    0.5 % of the values here: ROADMAP section C), and is within
    tests/test_quant.py's relative error 0.08 of the port's float
    ResUNet."""
    jm, jv, tm = resunets
    x = np.random.default_rng(4).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    apply_q, qvars = jquant.quantized_restorer(jm, jv)
    ref = apply_q(qvars, x)
    q = quant.quantized_restorer(tm)
    assert isinstance(q, quant.Int8ResUNet)
    with torch.no_grad():
        got = q(_nchw(x))
        fp = tm(_nchw(x))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert np.array_equal(_nhwc(got), np.asarray(ref.astype(jnp.float32)))
    assert _rel_err(_nhwc(fp), _nhwc(got)) < 0.08
    with pytest.raises(ValueError, match="divisible by 8"):
        q(torch.zeros(1, 3, 36, 32))


@pytest.mark.parametrize("input_minmax", [False, True],
                         ids=["plain", "input_minmax"])
def test_int8_simple_unet_matches_jax_and_fp(input_minmax):
    """The int8 SimpleUNet returns bf16 equal to tsr_tpu's un-jitted int8
    forward bit for bit, with and without the float32 min-max stretch (on a
    fog-like input range); within tests/test_quant.py's relative error
    0.06 of the port's float SimpleUNet. (tsr_tpu's jitted forward
    differs from its own un-jitted one here: ROADMAP section C.)"""
    jm, jv, tm = _unets(input_minmax)
    lo, hi = (0.6, 0.9) if input_minmax else (0.0, 1.0)
    x = np.random.default_rng(5 if input_minmax else 3).uniform(
        lo, hi, (4, SIZE, SIZE, 3)).astype(np.float32)
    apply_q, qvars = jquant.quantized_restorer(jm, jv)
    ref = apply_q(qvars, x).astype(jnp.float32)
    q = quant.quantized_restorer(tm)
    assert isinstance(q, quant.Int8SimpleUNet)
    with torch.no_grad():
        got = q(_nchw(x))
        fp = tm(_nchw(x))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_nhwc(got), np.asarray(ref))
    assert _rel_err(_nhwc(fp), _nhwc(got)) < 0.06
    with pytest.raises(TypeError, match="no int8 form"):
        quant.quantized_restorer(torch.nn.Conv2d(3, 3, 1))


def test_int8_convolutions_run_in_chunks(monkeypatch, resunets):
    """With MAX_PRODUCT_BYTES small enough that every convolution runs
    one image per chunk (and the bottleneck's products have 16 rows, so
    their operands are padded), the int8 ResUNet's output is unchanged."""
    _, _, tm = resunets
    q = quant.quantized_restorer(tm)
    x = torch.rand(3, 3, SIZE, SIZE, generator=torch.Generator()
                   .manual_seed(6))
    with torch.no_grad():
        whole = q(x)
        monkeypatch.setattr(quant, "MAX_PRODUCT_BYTES", 1)
        chunked = q(x)
    assert torch.equal(whole, chunked)


# -------------------------------------------------------- fused drop-in

@pytest.mark.parametrize("restore", [True, False],
                         ids=["restore-classify", "classify-only"])
def test_int8_modules_drop_into_the_fused_step(restore, resunets):
    """make_fused_eval_step(Int8ResUNet, Int8VGG16) (or the int8 judge
    alone) against tsr_tpu's make_fused_eval_step on its quantized applies
    (jitted there, as that step always is) on 16 uint8 images: preds
    equal, confidences within 2e-6 (measured 5.7e-7 and 1.2e-7: the
    jitted reference's own rounding, ROADMAP section C). The judge's head
    is scaled by 10 and centred on this batch's float logits (the port's
    float judge on the port's restored images), so the preds
    spread over the 4 classes. The bf16 restorer output goes through the
    step's clamp in bf16 on both sides."""
    jr, jrv, tr = resunets
    jj, jjv, tj = _judges(num_classes=4)
    imgs = np.random.default_rng(7).integers(0, 256, (16, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    labels = np.arange(16) % 4
    ra, rq = jquant.quantized_restorer(jr, jrv) if restore else (None, None)
    tq = quant.quantized_restorer(tr) if restore else None
    x01 = timage.to_float01(_t(imgs))
    with torch.no_grad():
        if restore:
            x01 = teval.restore_batch(tq, x01)
        logits = tj(_nchw_view(timage.imagenet_normalize(x01))).numpy()
    head = jjv["params"]["classifier_6"]
    jjv["params"]["classifier_6"] = {"kernel": head["kernel"] * 10,
                                     "bias": head["bias"]
                                     - 10 * logits.mean(0)}
    tj.load_state_dict(checkpoint.vgg16_from_jax(jjv))
    ja, jq = jquant.quantized_judge(jj, jjv)
    ref = jeval.make_fused_eval_step(ra, ja)(rq, jq, imgs, labels)
    step = teval.make_fused_eval_step(tq, quant.quantized_judge(tj),
                                      device="cpu")
    out = step(imgs, labels)
    assert len(np.unique(np.asarray(ref["pred"]))) == 4
    assert np.array_equal(out["pred"].numpy(), np.asarray(ref["pred"]))
    assert out["correct"].item() == int(ref["correct"])
    assert np.abs(out["confidence"].numpy()
                  - np.asarray(ref["confidence"])).max() <= 2e-6


# ------------------------------------------------------ package boundary

def test_quant_imports_no_jax_and_uses_int_mm_not_conv2d():
    """Importing tsr_tpu_torch.quant loads neither jax nor tsr_tpu; a
    quantized forward runs its int8 products through torch._int_mm only
    (F.conv2d on int8 wraps, so it must not be reached): 21 in a ResUNet
    (8, 16) / 16 (15 3x3, 3 shortcuts, the final 1x1, 2 transposed) and 4
    in a one-conv judge (1 conv, 3 dense)."""
    code = (
        "import sys, torch\n"
        "import torch.nn.functional as F\n"
        "import tsr_tpu_torch.quant as q\n"
        "from tsr_tpu_torch.models import ResUNet, VGG16\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tsr_tpu')]\n"
        "assert not bad, bad\n"
        "calls = []\n"
        "mm, conv = torch._int_mm, F.conv2d\n"
        "torch._int_mm = lambda *a: calls.append('mm') or mm(*a)\n"
        "F.conv2d = lambda *a, **k: calls.append('conv') or conv(*a, **k)\n"
        "torch.manual_seed(0)\n"
        "r = q.quantized_restorer(ResUNet((8, 16), 16).eval())\n"
        "j = q.quantized_judge(VGG16(num_classes=3, cfg=(8, 'M'), "
        "fc_width=16, input_size=16).eval())\n"
        "with torch.no_grad():\n"
        "    j(r(torch.rand(2, 3, 16, 16)).float())\n"
        "assert 'conv' not in calls and calls.count('mm') == 21 + 4, calls\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
