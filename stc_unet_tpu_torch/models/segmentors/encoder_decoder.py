"""EncoderDecoder segmentor
(≙ ``stc_unet_tpu/models/segmentors/encoder_decoder.py``).

An ``nn.Module`` with ``backbone`` and ``decode_head``, so its
``state_dict`` keys are the fork's checkpoint keys. Its public functions
take and return NHWC tensors (numpy arrays are accepted), like the JAX
ones; inside, the net runs NCHW in ``channels_last``, so the NHWC views
cost no copy.

Slide inference is the JAX package's: all tiles are gathered with static
offsets into one batch, run through the net at once, scatter-added back
in tile order, and multiplied by the precomputed ``1 / count`` of the
overlaps.

``set_mesh`` shards inference over the ranks of a ``('data',)`` mesh, the
counterpart of the JAX ``'data'`` sharding: whole mode splits the image
batch, slide mode the batch of tiles, into contiguous chunks (padded to
a multiple of the ranks), each rank runs its chunk, and one all-reduce
of a zero-filled buffer gives every rank all the logits, stitched in the
unsharded order. Every rank must make the call.

The graph is the JAX one: backbone, then the ``neck`` where there is
one, then every head on what the neck gives (``_features``, the one path
of inference, ``extract_feat`` and the losses). A neck sizes its convs
from the backbone's ``out_channels``, and the heads theirs from the
neck's (``feature_channels``).

Training is ``forward_train``/``compute_losses`` in the module's current
mode: call ``.train()`` first, as ``EncoderDecoder.__init__`` and
``init_segmentor`` leave the model in eval. ``engine.make_train_step``
does that, and takes the optimizer step. The auxiliary heads (one, or a
list: mmseg's ``nn.ModuleList``) run there only, on the neck's (else the
backbone's) features, never at inference; their losses join the decode
head's under ``aux`` (one head) or ``aux_{i}``.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from stc_unet_tpu_torch.core.utils import add_prefix
from stc_unet_tpu_torch.ops import resize
from stc_unet_tpu_torch.utils.util_distribution import mesh_group
from .. import builder
from ..bricks import BatchNorm
from ..builder import SEGMENTORS
from .base import BaseSegmentor


def _pretrained(init_cfg) -> bool:
    return isinstance(init_cfg, dict) and init_cfg.get('type') == 'Pretrained'


@SEGMENTORS.register_module()
class EncoderDecoder(BaseSegmentor):
    """backbone → (neck) → decode_head (and the auxiliary heads, in
    training)."""

    def __init__(self, backbone, decode_head, neck=None, auxiliary_head=None,
                 train_cfg=None, test_cfg=None, pretrained=None,
                 init_cfg=None):
        super().__init__(init_cfg)
        if pretrained is not None or backbone.get('pretrained') or \
                _pretrained(backbone.get('init_cfg')) or \
                _pretrained(init_cfg):
            raise NotImplementedError(
                'pretrained weights are not loaded yet (ROADMAP.md §1, '
                'item 20); strip the pretrained path or the Pretrained '
                'init_cfg to train from random weights')
        self.backbone = builder.build_backbone(backbone)
        feature_channels = dict(feature_channels=self.backbone.out_channels)
        self.neck = None
        if neck is not None:
            self.neck = builder.build_neck(neck, default_args=feature_channels)
            feature_channels = dict(feature_channels=self.neck.out_channels)
        self.decode_head = builder.build_head(
            decode_head, default_args=feature_channels)
        if isinstance(auxiliary_head, (list, tuple)):
            self.auxiliary_head = nn.ModuleList([
                builder.build_head(c, default_args=feature_channels)
                for c in auxiliary_head])
        elif auxiliary_head is not None:
            self.auxiliary_head = builder.build_head(
                auxiliary_head, default_args=feature_channels)
        else:
            self.auxiliary_head = None
        self.align_corners = self.decode_head.align_corners
        self.num_classes = self.decode_head.num_classes
        self.out_channels = self.decode_head.final_out_channels
        self.train_cfg = train_cfg
        self.test_cfg = dict(test_cfg or {})
        self._inv_counts: Dict[tuple, torch.Tensor] = {}
        self.mesh_group = None
        self.eval()

    def set_mesh(self, mesh):
        """Shard inference over a ``('data',)`` mesh (a ``DeviceMesh`` or
        a process group; None, or one rank, unshards). A ``'spatial'``
        axis raises (ROADMAP.md §1, item 14b)."""
        self.mesh_group = mesh_group(mesh)

    # -- initialization ------------------------------------------------------
    def init_weights(self, seed: int = 0):
        """Random weights from ``seed``, drawn on the CPU by one
        ``torch.Generator`` in module order (so every device gets the same
        values): torch's default uniform bounds for convs, transposed convs
        and linears, identity BN and LayerNorm, and any other module's
        own ``reset_parameters(generator)`` for the parameters it holds
        itself (the packed in_proj, the relative-position bias tables,
        ViT's ``cls_token`` and position ``embedding``)."""
        g = torch.Generator().manual_seed(seed)

        def uniform_(p, bound):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))

        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    uniform_(m.weight, bound)
                    if m.bias is not None:
                        uniform_(m.bias, bound)
                elif isinstance(m, (BatchNorm, nn.LayerNorm)):
                    m.reset_parameters()
                elif hasattr(m, 'reset_parameters'):
                    m.reset_parameters(g)
        return self

    # -- helpers -------------------------------------------------------------
    def loss_heads(self):
        """``(prefix, head)`` of every head that adds losses: ``decode``,
        then ``aux`` for one auxiliary head or ``aux_{i}`` for a list (JAX
        ``encoder_decoder.py:250-269``)."""
        heads = [('decode', self.decode_head)]
        if isinstance(self.auxiliary_head, nn.ModuleList):
            heads += [(f'aux_{i}', h) for i, h in
                      enumerate(self.auxiliary_head)]
        elif self.auxiliary_head is not None:
            heads.append(('aux', self.auxiliary_head))
        return heads

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _as_input(self, img):
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.ascontiguousarray(img))
        if img.dtype == torch.float64:
            img = img.float()
        return img.to(self.device)

    def _logits(self, img):
        """encode_decode on an NHWC tensor on the model's device; with a
        mesh, each rank runs its contiguous chunk of the batch."""
        if self.mesh_group is not None:
            return self._sharded_logits(img)
        return self._net_logits(img)

    def _features(self, x, generator=None):
        """The backbone's NCHW features of the NCHW x, through the neck
        where there is one: what every head reads."""
        feats = self.backbone(x, generator)
        return feats if self.neck is None else self.neck(feats)

    def _net_logits(self, img):
        out = self.decode_head(self._features(img.permute(0, 3, 1, 2)))
        return resize(out.permute(0, 2, 3, 1), size=img.shape[1:3],
                      mode='bilinear', align_corners=self.align_corners,
                      warning=False)

    def _sharded_logits(self, img):
        """The batch padded (with its last image) to ``k`` images a rank,
        rank r's ``[r·k, (r+1)·k)`` run here, and the logits of all
        ranks summed into a zero-filled buffer by one all-reduce (one
        collective, which gloo also runs on the card); the padding is
        cut off."""
        group = self.mesh_group
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        n = img.shape[0]
        k = -(-n // world)
        padded = img if k * world == n else torch.cat(
            [img, img[-1:].expand(k * world - n, *img.shape[1:])])
        mine = self._net_logits(padded[rank * k:(rank + 1) * k])
        out = mine.new_zeros((k * world,) + mine.shape[1:])
        out[rank * k:(rank + 1) * k] = mine
        dist.all_reduce(out, group=group)
        return out[:n]

    # -- feature extraction / encode-decode ----------------------------------
    @torch.inference_mode()
    def extract_feat(self, img):
        """The features the heads read, NHWC: the backbone's, through the
        neck where there is one (mmseg's ``extract_feat``)."""
        x = self._as_input(img).permute(0, 3, 1, 2)
        return [f.permute(0, 2, 3, 1) for f in self._features(x)]

    @torch.inference_mode()
    def encode_decode(self, img, img_metas=None):
        """Logits at the input size, NHWC."""
        return self._logits(self._as_input(img))

    # -- training ------------------------------------------------------------
    def compute_losses(self, img, gt_semantic_seg, generator=None):
        """The loss dict of an NHWC image batch against its labels
        ((N, H, W), or (N, H, W, 1) / (N, 1, H, W), which are squeezed), in
        the module's current mode. ``generator`` draws every random mask
        and seed of the backbone and the head."""
        img = self._as_input(img)
        gt = torch.as_tensor(gt_semantic_seg).to(self.device)
        if gt.ndim == 4:
            gt = gt[..., 0] if gt.shape[-1] == 1 else gt[:, 0]
        feats = self._features(img.permute(0, 3, 1, 2), generator)
        losses = {}
        for prefix, head in self.loss_heads():
            logits = head(feats, generator)
            losses.update(add_prefix(head.loss_by_feat(
                logits.permute(0, 2, 3, 1), gt), prefix))
        return losses

    def forward_train(self, img, img_metas, gt_semantic_seg, generator=None,
                      **kwargs):
        return self.compute_losses(img, gt_semantic_seg, generator)

    # -- inference -----------------------------------------------------------
    def _slide_offsets(self, h_img: int, w_img: int):
        h_stride, w_stride = self.test_cfg['stride']
        h_crop, w_crop = self.test_cfg['crop_size']
        h_crop, w_crop = min(h_crop, h_img), min(w_crop, w_img)
        h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
        w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
        offsets = []
        for h_idx in range(h_grids):
            for w_idx in range(w_grids):
                y1 = h_idx * h_stride
                x1 = w_idx * w_stride
                y2 = min(y1 + h_crop, h_img)
                x2 = min(x1 + w_crop, w_img)
                y1 = max(y2 - h_crop, 0)
                x1 = max(x2 - w_crop, 0)
                offsets.append((y1, x1))
        return tuple(offsets), (h_crop, w_crop)

    def _inv_count(self, h_img, w_img, offsets, crop):
        key = (h_img, w_img, offsets, crop, self.device)
        if key not in self._inv_counts:
            count = np.zeros((1, h_img, w_img, 1), np.float32)
            for (y, x) in offsets:
                count[:, y:y + crop[0], x:x + crop[1], :] += 1
            assert (count > 0).all()
            self._inv_counts[key] = torch.from_numpy(1.0 / count).to(
                self.device)
        return self._inv_counts[key]

    @torch.inference_mode()
    def slide_inference(self, img, img_meta, rescale):
        """Sliding-window inference, all tiles in one batch."""
        img = self._as_input(img)
        b, h_img, w_img, _ = img.shape
        offsets, (h_crop, w_crop) = self._slide_offsets(h_img, w_img)
        tiles = torch.cat([img[:, y:y + h_crop, x:x + w_crop, :]
                           for (y, x) in offsets], 0)    # (G*B, hc, wc, C)
        logits = self._logits(tiles).reshape(len(offsets), b, h_crop, w_crop,
                                             self.out_channels)
        preds = logits.new_zeros((b, h_img, w_img, self.out_channels))
        for g, (y, x) in enumerate(offsets):
            preds[:, y:y + h_crop, x:x + w_crop, :] += logits[g]
        preds = preds * self._inv_count(h_img, w_img, offsets,
                                         (h_crop, w_crop))
        if rescale:
            preds = self._rescale(preds, img_meta)
        return preds

    def _rescale(self, seg_logit, img_meta):
        resize_shape = img_meta[0]['img_shape'][:2]
        seg_logit = seg_logit[:, :resize_shape[0], :resize_shape[1], :]
        return resize(seg_logit, size=img_meta[0]['ori_shape'][:2],
                      mode='bilinear', align_corners=self.align_corners,
                      warning=False)

    @torch.inference_mode()
    def whole_inference(self, img, img_meta, rescale):
        seg_logit = self.encode_decode(img, img_meta)
        if rescale:
            seg_logit = self._rescale(seg_logit, img_meta)
        return seg_logit

    @torch.inference_mode()
    def inference(self, img, img_meta, rescale):
        """slide/whole + sigmoid/softmax + flip back."""
        mode = self.test_cfg.get('mode', 'whole')
        assert mode in ['slide', 'whole']
        ori_shape = img_meta[0]['ori_shape']
        assert all(_['ori_shape'] == ori_shape for _ in img_meta)
        if mode == 'slide':
            seg_logit = self.slide_inference(img, img_meta, rescale)
        else:
            seg_logit = self.whole_inference(img, img_meta, rescale)
        if self.out_channels == 1:
            output = torch.sigmoid(seg_logit)
        else:
            output = torch.softmax(seg_logit, dim=-1)
        if img_meta[0].get('flip', False):
            flip_direction = img_meta[0]['flip_direction']
            assert flip_direction in ['horizontal', 'vertical']
            output = output.flip(2 if flip_direction == 'horizontal' else 1)
        return output

    def _predict(self, seg_logit):
        if self.out_channels == 1:
            thr = self.decode_head.final_threshold
            seg_pred = (seg_logit[..., 0] > thr).to(seg_logit.dtype)
        else:
            seg_pred = seg_logit.argmax(-1)
        return list(seg_pred.cpu().numpy())

    def simple_test(self, img, img_meta, rescale=True):
        """Single-aug test → list of (H, W) numpy label maps."""
        return self._predict(self.inference(img, img_meta, rescale))

    def aug_test(self, imgs, img_metas, rescale=True):
        """Logit-averaging TTA."""
        assert rescale
        seg_logit = self.inference(imgs[0], img_metas[0], rescale)
        for i in range(1, len(imgs)):
            seg_logit = seg_logit + self.inference(imgs[i], img_metas[i],
                                                   rescale)
        return self._predict(seg_logit / len(imgs))
