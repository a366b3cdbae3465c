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

Training is ``forward_train``/``compute_losses`` in the module's current
mode: call ``.train()`` first, as ``EncoderDecoder.__init__`` and
``init_segmentor`` leave the model in eval. ``engine.make_train_step``
does that, and takes the optimizer step.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from stc_unet_tpu_torch.core.utils import add_prefix
from stc_unet_tpu_torch.ops import resize
from .. import builder
from ..backbones.unet_backbone import MultiheadAttention
from ..bricks import BatchNorm
from ..builder import SEGMENTORS
from ..utils.maxvit_core import RelativeSelfAttention
from .base import BaseSegmentor


@SEGMENTORS.register_module()
class EncoderDecoder(BaseSegmentor):
    """backbone → decode_head."""

    def __init__(self, backbone, decode_head, neck=None, auxiliary_head=None,
                 train_cfg=None, test_cfg=None, pretrained=None,
                 init_cfg=None):
        super().__init__(init_cfg)
        if neck is not None or auxiliary_head is not None:
            raise NotImplementedError(
                'necks and auxiliary heads are not ported yet')
        if pretrained is not None or backbone.get('pretrained'):
            raise NotImplementedError(
                'pretrained backbones are not ported yet')
        self.backbone = builder.build_backbone(backbone)
        self.decode_head = builder.build_head(
            decode_head,
            default_args=dict(feature_channels=self.backbone.out_channels))
        self.align_corners = self.decode_head.align_corners
        self.num_classes = self.decode_head.num_classes
        self.out_channels = self.decode_head.final_out_channels
        self.train_cfg = train_cfg
        self.test_cfg = dict(test_cfg or {})
        self._inv_counts: Dict[tuple, torch.Tensor] = {}
        self.eval()

    # -- initialization ------------------------------------------------------
    def init_weights(self, seed: int = 0):
        """Random weights from ``seed``, drawn on the CPU by one
        ``torch.Generator`` in module order (so every device gets the same
        values): torch's default uniform bounds for convs, transposed convs
        and linears, Xavier for the packed in_proj, a normal of std 0.02
        cut at 2 std for the relative-position bias tables (flax's
        ``truncated_normal(0.02)``), identity BN and LayerNorm."""
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
                elif isinstance(m, MultiheadAttention):
                    c3, c = m.in_proj_weight.shape
                    uniform_(m.in_proj_weight, math.sqrt(6.0 / (c + c3)))
                    m.in_proj_bias.zero_()
                elif isinstance(m, RelativeSelfAttention):
                    t = m.relative_position_bias_table
                    t.copy_(nn.init.trunc_normal_(
                        torch.empty(t.shape), std=0.02, a=-0.04, b=0.04,
                        generator=g))
                elif isinstance(m, (BatchNorm, nn.LayerNorm)):
                    m.reset_parameters()
        return self

    # -- helpers -------------------------------------------------------------
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
        """encode_decode on an NHWC tensor on the model's device."""
        out = self.decode_head(self.backbone(img.permute(0, 3, 1, 2)))
        return resize(out.permute(0, 2, 3, 1), size=img.shape[1:3],
                      mode='bilinear', align_corners=self.align_corners,
                      warning=False)

    # -- feature extraction / encode-decode ----------------------------------
    @torch.inference_mode()
    def extract_feat(self, img):
        """Backbone features, NHWC."""
        x = self._as_input(img).permute(0, 3, 1, 2)
        return [f.permute(0, 2, 3, 1) for f in self.backbone(x)]

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
        feats = self.backbone(img.permute(0, 3, 1, 2), generator)
        logits = self.decode_head(feats, generator)
        return add_prefix(self.decode_head.loss_by_feat(
            logits.permute(0, 2, 3, 1), gt), 'decode')

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
