"""The port's losses (``stc_unet_tpu_torch/models/losses``) and the decode
head's ``loss_by_feat`` against the JAX package, on the CPU.

Inputs are made with numpy from a seed, with ignored (255) pixels in the
labels. Both sides compute in f32 from the same values; the sums and the
log-softmax are taken in other orders, so values agree to rtol 1e-5 /
atol 1e-6. The trap pinned here: the default CE mean divides by ALL
pixels (ignored ones count as 0), not by the valid count as
``F.cross_entropy(ignore_index=255)`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stc_unet_tpu.models import losses as jl
from stc_unet_tpu.models.decode_heads.decode_head import \
    BaseDecodeHead as JHead
from stc_unet_tpu.models.losses.dice_loss import \
    binary_dice_loss as jbinary_dice_loss
from stc_unet_tpu_torch.models import losses as tl
from stc_unet_tpu_torch.models.decode_heads.decode_head import \
    BaseDecodeHead as THead
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _data(n=2, h=6, w=7, c=3, seed=0, ignore=True):
    rng = np.random.RandomState(seed)
    pred = rng.randn(n, h, w, c).astype(np.float32)
    label = rng.randint(0, c, (n, h, w)).astype(np.int64)
    if ignore:
        label[rng.rand(n, h, w) < 0.2] = 255
    return pred, label


def _close(out, ref):
    if isinstance(out, (list, tuple)):
        for o, r in zip(out, ref):
            _close(o, r)
        return
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def _both(fn_t, fn_j, *arrays, **kwargs):
    return (fn_t(*[torch.from_numpy(a) for a in arrays], **kwargs),
            fn_j(*[jnp.asarray(a) for a in arrays], **kwargs))


@pytest.mark.parametrize('kwargs', [
    dict(), dict(avg_non_ignore=True), dict(class_weight=[0.3, 1.0, 2.0]),
    dict(class_weight=[0.3, 1.0, 2.0], avg_non_ignore=True),
    dict(reduction='sum'), dict(reduction='none')])
def test_cross_entropy_matches_jax(kwargs):
    pred, label = _data()
    out, ref = _both(tl.cross_entropy, jl.cross_entropy, pred, label,
                     ignore_index=255, **kwargs)
    _close(out, ref)


def test_cross_entropy_mean_counts_ignored_pixels():
    pred, label = _data(seed=1)
    valid = label != 255
    out = tl.cross_entropy(torch.from_numpy(pred), torch.from_numpy(label),
                           ignore_index=255)
    torch_mean = F.cross_entropy(torch.from_numpy(pred).permute(0, 3, 1, 2),
                                 torch.from_numpy(label), ignore_index=255)
    np.testing.assert_allclose(out.item(),
                               torch_mean.item() * valid.mean(), rtol=1e-5)


def test_cross_entropy_pixel_weight_and_avg_factor_match_jax():
    pred, label = _data(seed=2)
    weight = np.random.RandomState(3).rand(*label.shape).astype(np.float32)
    out, ref = _both(tl.cross_entropy, jl.cross_entropy, pred, label, weight,
                     ignore_index=255, avg_factor=17.0)
    _close(out, ref)


@pytest.mark.parametrize('case', ['int_labels', 'float_labels', 'one_channel',
                                  'class_weight', 'avg_non_ignore'])
def test_binary_cross_entropy_matches_jax(case):
    pred, label = _data(seed=4)
    kwargs = dict(ignore_index=255)
    if case == 'float_labels':
        label = (np.random.RandomState(5).rand(*pred.shape) > 0.5).astype(
            np.float32)
    elif case == 'one_channel':
        pred, label = pred[..., :1], np.where(label == 255, 255,
                                              label % 2)
    elif case == 'class_weight':
        kwargs['class_weight'] = [0.5, 1.0, 3.0]
    elif case == 'avg_non_ignore':
        kwargs['avg_non_ignore'] = True
    out, ref = _both(tl.binary_cross_entropy, jl.binary_cross_entropy, pred,
                     label, **kwargs)
    _close(out, ref)


@pytest.mark.parametrize('spatial', [True, False])
def test_mask_cross_entropy_matches_jax(spatial):
    rng = np.random.RandomState(6)
    shape = (3, 5, 4, 4) if spatial else (3, 4)
    pred = rng.randn(*shape).astype(np.float32)
    target = (rng.rand(*shape[:-1]) > 0.5).astype(np.float32)
    label = np.array([2, 0, 3])
    out = tl.mask_cross_entropy(torch.from_numpy(pred),
                                torch.from_numpy(target), label)
    ref = jl.mask_cross_entropy(jnp.asarray(pred), jnp.asarray(target), label)
    assert out.shape == (1,)
    _close(out, ref)


@pytest.mark.parametrize('kwargs', [
    dict(), dict(class_weight=[1.0, 0.5, 2.0]), dict(exponent=3, smooth=0.5),
    dict(loss_weight=0.4, reduction='sum')])
def test_dice_loss_matches_jax(kwargs):
    """255s in the labels: the valid mask applies in the numerator only and
    labels are clipped to C-1 before the one-hot, on both sides."""
    pred, label = _data(seed=7)
    out, ref = _both(tl.DiceLoss(**kwargs), jl.DiceLoss(**kwargs), pred,
                     label)
    _close(out, ref)


def test_binary_dice_loss_matches_jax():
    rng = np.random.RandomState(8)
    pred = rng.rand(2, 5, 6).astype(np.float32)
    target = (rng.rand(2, 5, 6) > 0.5).astype(np.float32)
    valid = (rng.rand(2, 5, 6) > 0.2).astype(np.int32)
    out = tl.binary_dice_loss(torch.from_numpy(pred),
                              torch.from_numpy(target),
                              valid_mask=torch.from_numpy(valid),
                              reduction='none')
    ref = jbinary_dice_loss(jnp.asarray(pred), jnp.asarray(target),
                            valid_mask=jnp.asarray(valid), reduction='none')
    assert out.shape == (2,)
    _close(out, ref)


@pytest.mark.parametrize('kwargs', [
    dict(), dict(ignore_index=255), dict(topk=(1, 2), ignore_index=255),
    dict(topk=2, thresh=0.3), dict(topk=(1, 3), thresh=-0.5)])
def test_accuracy_matches_jax(kwargs):
    pred, label = _data(seed=9)
    if 'ignore_index' not in kwargs:
        label = np.where(label == 255, 0, label)
    out, ref = _both(tl.accuracy, jl.accuracy, pred, label, **kwargs)
    _close(out, ref)
    acc_t = tl.Accuracy(topk=(1, 2), ignore_index=255)
    acc_j = jl.Accuracy(topk=(1, 2), ignore_index=255)
    _close(acc_t(torch.from_numpy(pred), torch.from_numpy(label)),
           acc_j(jnp.asarray(pred), jnp.asarray(label)))


@pytest.mark.parametrize('cfg', [
    dict(type='CrossEntropyLoss', loss_weight=0.7),
    dict(type='CrossEntropyLoss', use_sigmoid=True, avg_non_ignore=True),
    dict(type='CrossEntropyLoss', class_weight=[1.0, 2.0, 0.5],
         avg_non_ignore=True)])
def test_cross_entropy_loss_class_matches_jax(cfg):
    from stc_unet_tpu.models.builder import build_loss as jbuild
    from stc_unet_tpu_torch.models import build_loss as tbuild
    pred, label = _data(seed=10)
    out, ref = _both(tbuild(dict(cfg)), jbuild(dict(cfg)), pred, label,
                     ignore_index=255)
    _close(out, ref)
    out, ref = _both(tbuild(dict(cfg)), jbuild(dict(cfg)), pred, label,
                     ignore_index=255, reduction_override='sum')
    _close(out, ref)


def test_reduce_helpers_match_jax():
    loss = np.random.RandomState(11).rand(3, 4).astype(np.float32)
    for reduction in ('none', 'mean', 'sum'):
        _close(tl.reduce_loss(torch.from_numpy(loss), reduction),
               jl.reduce_loss(jnp.asarray(loss), reduction))
    w = np.random.RandomState(12).rand(3, 1).astype(np.float32)
    _close(tl.weight_reduce_loss(torch.from_numpy(loss), torch.from_numpy(w),
                                 avg_factor=5.0),
           jl.weight_reduce_loss(jnp.asarray(loss), jnp.asarray(w),
                                 avg_factor=5.0))
    with pytest.raises(ValueError):
        tl.weight_reduce_loss(torch.from_numpy(loss), reduction='sum',
                              avg_factor=2.0)
    assert tl.get_class_weight([1, 2]) == [1, 2]


@pytest.mark.parametrize('align_corners', [False, True])
def test_loss_by_feat_matches_jax(align_corners):
    """Logits at half the label size (resized to it in f32), two loss
    entries that share one name (summed) and one of another name."""
    loss_decode = [
        dict(type='CrossEntropyLoss', loss_name='loss_mix', loss_weight=0.5),
        dict(type='DiceLoss', loss_name='loss_mix', loss_weight=2.0),
        dict(type='CrossEntropyLoss', loss_name='loss_ce',
             avg_non_ignore=True)]
    kwargs = dict(num_classes=3, in_channels=4, channels=4,
                  loss_decode=loss_decode, align_corners=align_corners)
    pred, _ = _data(h=4, w=5, seed=13)
    _, label = _data(h=8, w=10, seed=14)
    out = THead(**kwargs).loss_by_feat(
        torch.from_numpy(pred).to(torch.bfloat16), torch.from_numpy(label))
    ref = JHead(**kwargs).loss_by_feat(
        jnp.asarray(pred).astype(jnp.bfloat16), jnp.asarray(label))
    assert sorted(out) == sorted(ref) == ['acc_seg', 'loss_ce', 'loss_mix']
    for k in ref:
        assert out[k].dtype == torch.float32
        _close(out[k], ref[k])


def test_loss_by_feat_default_loss_and_sampler():
    head = THead(num_classes=3, in_channels=4, channels=4)
    pred, label = _data(seed=15)
    out = head.loss_by_feat(torch.from_numpy(pred), torch.from_numpy(label))
    ref = JHead(num_classes=3, in_channels=4, channels=4).loss_by_feat(
        jnp.asarray(pred), jnp.asarray(label))
    assert sorted(out) == ['acc_seg', 'loss_ce']
    _close(out['loss_ce'], ref['loss_ce'])
    head = THead(num_classes=3, in_channels=4, channels=4,
                 sampler=dict(type='OHEMPixelSampler'))
    with pytest.raises(NotImplementedError):
        head.loss_by_feat(torch.from_numpy(pred), torch.from_numpy(label))
