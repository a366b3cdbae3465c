"""The port's msgpack reader and ``.ckpt`` loading against the JAX package.

``utils/msgpack_decode.unpackb`` equals ``msgpack.unpackb`` on
hypothesis-drawn trees and at every length boundary of the format. A
``.ckpt`` written by the JAX package's ``save_checkpoint`` decodes to
arrays bit-identical to its ``load_checkpoint_file``'s, bfloat16 leaves
included. The tiny flagship STC-UNet and the tiny MaxViT-UNet load from a
``.ckpt`` with ``strict=True`` and give JAX's logits (rtol 1e-4 / atol
1e-5, the precedent of ``tests/test_torch_stc_unet.py``).
"""
import math
import os.path as osp
import warnings

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from stc_unet_tpu.engine import checkpoint as jax_ckpt
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.apis import init_segmentor
from stc_unet_tpu_torch.engine import checkpoint
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from stc_unet_tpu_torch.utils.msgpack_decode import ExtType, unpackb
from tests.fixtures.torch_port import (MAXVIT_CONFIG, jax_variables,
                                       tiny_config)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

# -- msgpack ------------------------------------------------------------------

_SCALARS = (st.none() | st.booleans() |
            st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1) |
            st.floats(allow_nan=False) | st.text() | st.binary() |
            st.builds(msgpack.ExtType, st.integers(0, 127), st.binary()))
_TREES = st.recursive(
    _SCALARS,
    lambda children: (st.lists(children, max_size=20) |
                      st.dictionaries(st.text(max_size=8), children,
                                      max_size=20)),
    max_leaves=60)


@settings(max_examples=200, deadline=None)
@given(tree=_TREES, single_float=st.booleans())
def test_unpackb_equals_msgpack_on_drawn_trees(tree, single_float):
    packed = msgpack.packb(tree, use_bin_type=True,
                           use_single_float=single_float)
    want = msgpack.unpackb(packed)
    assert unpackb(packed) == want
    assert unpackb(packed, raw=True) == msgpack.unpackb(packed, raw=True)


def _ext_hook(code, data):
    return ('hooked', code, data)


@pytest.mark.parametrize('n', [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_unpackb_at_every_length_boundary(n):
    """fixstr/str8/16/32, bin8/16/32, fixarray/array16/32,
    fixmap/map16/32, fixext and ext8/16/32, the ints of every width."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31,
            -2 ** 31 - 1, -2 ** 63]
    tree = dict(s='x' * n, b=b'y' * n, a=list(range(n % 300)) + ints,
                m={str(i): i for i in range(min(n, 70000))},
                e=msgpack.ExtType(5, b'z' * n), f=[1.5, -0.0, math.inf])
    packed = msgpack.packb(tree, use_bin_type=True)
    assert unpackb(packed) == msgpack.unpackb(packed)
    for size in (1, 2, 4, 8, 16, 3, n):
        blob = msgpack.packb(msgpack.ExtType(9, b'q' * size))
        assert unpackb(blob) == ExtType(9, b'q' * size) == \
            msgpack.unpackb(blob)
        assert unpackb(blob, ext_hook=_ext_hook) == \
            msgpack.unpackb(blob, ext_hook=_ext_hook)


def test_unpackb_rejects_bad_data():
    good = msgpack.packb([1, 'a', b'b'])
    with pytest.raises(ValueError, match='truncated'):
        unpackb(good[:-1])
    with pytest.raises(ValueError, match='extra data'):
        unpackb(good + b'\x00')
    with pytest.raises(ValueError, match='0xc1'):
        unpackb(b'\xc1')
    with pytest.raises(ValueError, match='map key'):
        unpackb(msgpack.packb({1: 2}))


# -- .ckpt files --------------------------------------------------------------

def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _bits(x):
    """A leaf's type, shape and bytes (bfloat16 as its int16 bits)."""
    if torch.is_tensor(x):
        assert x.dtype == torch.bfloat16
        return 'bfloat16', tuple(x.shape), x.view(torch.int16).numpy(
            ).tobytes()
    if isinstance(x, np.generic) or isinstance(x, np.ndarray):
        a = np.asarray(x)
        name = 'bfloat16' if a.dtype.name == 'bfloat16' else a.dtype.name
        bits = a.view(np.int16) if name == 'bfloat16' else a
        return name, a.shape, bits.tobytes()
    return type(x).__name__, (), repr(x)


def test_ckpt_decodes_like_the_jax_package(tmp_path):
    rng = np.random.RandomState(0)
    variables = {
        'params': {'conv': {'kernel': rng.randn(3, 3, 2, 4).astype(
            np.float32), 'bias': rng.randn(4).astype(np.float16)},
            'bf16': np.asarray(jnp.asarray(rng.randn(5, 3), jnp.bfloat16)),
            'ints': np.arange(6, dtype=np.int64).reshape(2, 3),
            'flags': np.array([True, False]),
            'u8': np.arange(7, dtype=np.uint8)},
        'batch_stats': {'bn': {'mean': rng.randn(4).astype(np.float32),
                               'var': np.float32(1.25)}},
        'extra': {'scalar_bf16': jnp.bfloat16(3.5), 'count': np.int32(7),
                  'step': 12, 'z': 1 + 2j, 'empty': {}},
    }
    opt_state = {'mu': {'w': rng.randn(3).astype(np.float32)},
                 'count': np.int32(4)}
    meta = dict(CLASSES=['background', 'target'], PALETTE=[[0, 0, 0],
                                                           [1, 1, 1]])
    path = str(tmp_path / 'a.ckpt')
    jax_ckpt.save_checkpoint(path, variables, opt_state=opt_state, step=9,
                             meta=meta)
    want, got = jax_ckpt.load_checkpoint_file(path), \
        checkpoint.load_checkpoint_file(path)
    assert got['meta'] == want['meta'] and got['step'] == want['step'] == 9
    for key in ('variables', 'opt_state'):
        ours, theirs = dict(_leaves(got[key])), dict(_leaves(want[key]))
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            assert _bits(ours[k]) == _bits(theirs[k]), k
    assert checkpoint.load_checkpoint_file(path)['variables']['extra'][
        'empty'] == {}


def test_chunked_leaves_are_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    path = str(tmp_path / 'chunked.ckpt')
    jax_ckpt.save_checkpoint(path, {'params': {'w': np.zeros(100,
                                                             np.float32)}})
    with pytest.raises(ValueError, match='params/w.*chunks'):
        checkpoint.load_checkpoint_file(path)


@pytest.fixture(scope='module')
def stc(tmp_path_factory):
    """(JAX segmentor, .ckpt path with CLASSES and PALETTE, one without)."""
    root = tmp_path_factory.mktemp('stc')
    jm = jax_build(tiny_config(JConfig).model)
    jm.variables = jax_variables(jm)
    with_meta, bare = str(root / 'with.ckpt'), str(root / 'bare.ckpt')
    jax_ckpt.save_checkpoint(with_meta, jm.variables, meta=dict(
        CLASSES=('kidney', 'tumour'), PALETTE=[[1, 2, 3], [4, 5, 6]]))
    jax_ckpt.save_checkpoint(bare, jm.variables)
    return jm, with_meta, bare


def _img(size=32, seed=1):
    return np.random.RandomState(seed).rand(2, size, size, 3).astype(
        np.float32)


def test_stc_unet_ckpt_loads_strict_and_gives_jax_logits(stc):
    jm, path, _ = stc
    tm = init_segmentor(tiny_config(Config), path, device='cpu')
    assert tm.CLASSES == ('kidney', 'tumour')
    assert tm.PALETTE == [[1, 2, 3], [4, 5, 6]]
    img = _img()
    np.testing.assert_allclose(tm.encode_decode(img).numpy(),
                               np.asarray(jm.encode_decode(img)),
                               rtol=1e-4, atol=1e-5)
    sd = jax_to_torch_state(jm.variables)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_maxvit_ckpt_loads_strict_and_gives_jax_logits(tmp_path):
    """MaxViT-UNet (``my_config/MaxViT-UNet.py`` at the tiny geometry of
    ``tests/test_torch_maxvit.py``) with numpy-drawn variables."""
    def cfg(config_cls):
        c = config_cls.fromfile(MAXVIT_CONFIG)
        c.model.backbone.update(depths=(1, 1, 1, 1), channels=(8, 8, 8, 8),
                                embed_dim=8, num_heads=2,
                                grid_window_size=(2, 2), mlp_ratio=2)
        c.model.decode_head.update(in_channels=[8, 8, 8, 8],
                                   output_size=(32, 32), num_heads=2,
                                   grid_window_size=(2, 2), depths=(1, 1, 1),
                                   channels=8, mlp_ratio=2.0)
        return c
    jm = jax_build(cfg(JConfig).model)
    jm.variables = jax_variables(jm, size=64)
    path = str(tmp_path / 'maxvit.ckpt')
    jax_ckpt.save_checkpoint(path, jm.variables, meta=dict(CLASSES=['a',
                                                                    'b']))
    tm = init_segmentor(cfg(Config), path, device='cpu')
    assert tm.CLASSES == ('a', 'b') and tm.PALETTE is None
    img = _img(64)
    np.testing.assert_allclose(tm.encode_decode(img).numpy(),
                               np.asarray(jm.encode_decode(img)),
                               rtol=1e-4, atol=1e-5)


def test_without_classes_in_the_meta_it_warns_and_takes_cityscapes(
        stc, tmp_path):
    jm, _, bare = stc
    pth = str(tmp_path / 'bare.pth')
    torch.save(jax_to_torch_state(jm.variables), pth)
    from stc_unet_tpu.core import get_classes
    for path in (bare, pth):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            tm = init_segmentor(tiny_config(Config), path, device='cpu')
        assert any('CLASSES is not saved' in str(x.message) for x in w)
        assert tm.CLASSES == get_classes('cityscapes')


@pytest.mark.parametrize('zipfile', [True, False])
def test_pth_files_load_with_their_meta(stc, tmp_path, zipfile):
    jm, _, _ = stc
    sd = jax_to_torch_state(jm.variables)
    path = str(tmp_path / 'w.pth')
    torch.save(dict(state_dict=sd, meta=dict(CLASSES=['x', 'y'])), path,
               _use_new_zipfile_serialization=zipfile)
    assert checkpoint.is_torch_file(path)
    tm = init_segmentor(tiny_config(Config), path, device='cpu')
    assert tm.CLASSES == ('x', 'y')
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bad = dict(sd)
    bad.pop(next(iter(bad)))
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match='Missing key'):
        init_segmentor(tiny_config(Config), path, device='cpu')


def test_bfloat16_ckpt_loads_as_its_float32_values(stc, tmp_path):
    jm, _, _ = stc
    to_bf16 = {c: {k: v for k, v in _nest(
        [(p, np.asarray(jnp.asarray(x, jnp.bfloat16)))
         for p, x in _leaves(t)]).items()}
        for c, t in jm.variables.items()}
    path = str(tmp_path / 'bf16.ckpt')
    jax_ckpt.save_checkpoint(path, to_bf16, step=3)
    ckpt = checkpoint.load_checkpoint_file(path)
    assert ckpt['step'] == 3 and 'opt_state' not in ckpt
    leaf = ckpt['variables']['params']['decode_head']['conv_seg']['conv'][
        'kernel']
    assert torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16
    tm = init_segmentor(tiny_config(Config), path, device='cpu')
    want = jax_to_torch_state({c: _nest([(p, np.asarray(x, np.float32))
                                         for p, x in _leaves(t)])
                               for c, t in to_bf16.items()})
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert osp.getsize(path) < osp.getsize(stc[2])


def _nest(items):
    out = {}
    for path, value in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out
