"""AudioRecognizer: the spectrogram classifier of the audio recipes.

Port of ``mscl_tpu/models/recognizers/audio_recognizer.py`` (reference
mmaction recognizers/audio_recognizer.py). A batch's ``audios`` are
(B, clips, 1, T, F) (``FormatAudioShape('NCTF')`` a sample); they run as
B * clips NCHW spectrograms (N, 1, T, F) through the 2D backbone
(``ResNetAudio``, or the 2D ``ResNet`` with ``in_channels=1``), then the
head (``AudioTSNHead``) and its loss.

- ``forward_train``: the head's loss over the flattened labels.
- ``forward_test``: each clip's scores, averaged over a video's clips,
  then softmaxed with ``average_clips='prob'`` (the JAX order: the mean of
  the scores, then the softmax; Recognizer3D's is the other way round).
- ``input_key`` names the batch entry the test and validation loops read
  (``apis.inference``): 'audios'. The JAX package's loops read 'imgs'
  alone (``mscl_tpu/apis/inference.py:44``), so its validation and test
  CLI stop on an audio batch with a KeyError; the port's run them.

Module names are the JAX tree's minus ``_m`` (``backbone``, ``cls_head``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES, HEADS, RECOGNIZERS
from .base import parse_losses
from .recognizer3d import Recognizer3D, _registered


@RECOGNIZERS.register_module()
class AudioRecognizer(nn.Module):
    input_key = 'audios'

    def __init__(self, backbone, cls_head, train_cfg=None, test_cfg=None,
                 dtype=None):
        super().__init__()
        self.dtype = compute_dtype.resolve_dtype(dtype)
        bb_cfg = dict(backbone)
        bb_cfg.pop('pretrained', None)
        self.backbone = _registered(BACKBONES, 'backbone',
                                    bb_cfg.pop('type'))(dtype=self.dtype,
                                                        **bb_cfg)
        head_cfg = dict(cls_head)
        self.cls_head = _registered(HEADS, 'head', head_cfg.pop('type'))(
            dtype=self.dtype, **head_cfg)
        self.train_cfg = train_cfg
        self.test_cfg = dict(test_cfg or {})

    init_weights = Recognizer3D.init_weights
    neck = None
    _dropouts = Recognizer3D._dropouts
    seed_dropout = Recognizer3D.seed_dropout
    dropout_state = Recognizer3D.dropout_state
    set_dropout_state = Recognizer3D.set_dropout_state

    @staticmethod
    def _clips(audios: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """(B, clips, 1, T, F) -> (B * clips, 1, T, F), clips."""
        num_clips = audios.shape[1]
        return audios.reshape((-1,) + tuple(audios.shape[-3:])), num_clips

    def forward_train(self, audios: torch.Tensor, labels: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        x, _ = self._clips(audios)
        return self.cls_head.loss(self.cls_head(self.backbone(x)),
                                  labels.reshape(-1))

    def forward_test(self, audios: torch.Tensor) -> torch.Tensor:
        x, num_clips = self._clips(audios)
        score = self.cls_head(self.backbone(x))
        score = score.reshape((-1, num_clips) + tuple(score.shape[1:])) \
            .mean(dim=1)
        if self.test_cfg.get('average_clips') == 'prob':
            score = F.softmax(score, dim=-1)
        return score

    def forward(self, audios, labels: Optional[torch.Tensor] = None,
                return_loss: bool = True):
        if return_loss and labels is not None:
            return self.forward_train(audios, labels)
        return self.forward_test(audios)

    def train_step(self, batch) -> Tuple[torch.Tensor, Dict]:
        return parse_losses(self.forward_train(batch['audios'],
                                               batch['label']))
