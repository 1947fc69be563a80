"""Scores, features and retrieval (port of ``mscl_tpu/apis/inference.py``,
reference mmaction apis/test.py and tools/test_retrival.py).

A batch runs as the loader gives it: the JAX package pads the last partial
batch only to keep jit's shapes static, and in eval mode (BN's running
statistics, no dropout) a video's scores do not depend on its batch. The
model runs where its parameters are.

In a process group (``parallel/dist.py``) each rank's loader gives its rows
of each global batch, the short last one tiled to the full batch as the JAX
package pads it (``NumpyLoader(pad_last=True)``); each rank forwards its
rows, and the outputs are gathered in rank order and trimmed to the
dataset's videos, so every rank gets every video's output in dataset
order. ``retrieval_recall`` runs where it is called (rank 0 in the CLI).
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel import dist
from ..utils.device import resolve_device


def _forward_each_batch(model, method: str, loader) -> List[np.ndarray]:
    """``model.<method>(imgs)`` on every batch, in eval mode without
    gradients; the rows as float32 numpy arrays (in a process group every
    rank's, in dataset order: see above). The batch entry is the model's
    ``input_key`` ('imgs'; an AudioRecognizer's 'audios')."""
    device = next(model.parameters()).device
    fn = getattr(model, method)
    key = getattr(model, 'input_key', 'imgs')
    was_training = model.training
    model.eval()
    out: List[np.ndarray] = []
    left = len(loader.dataset)
    try:
        with torch.no_grad():
            for batch in loader:
                imgs = torch.from_numpy(
                    np.ascontiguousarray(batch[key])).to(device)
                rows = fn(imgs).float()
                if dist.is_distributed():
                    rows = dist.all_gather_rows(rows, tag='eval_rows')
                    rows = rows[:min(left, loader.batch_size)]
                    left -= rows.shape[0]
                out.extend(rows.cpu().numpy())
    finally:
        model.train(was_training)
    return out


def make_eval_fn(model) -> Callable:
    """``eval_fn(loader) -> list of each video's scores`` (reference
    single_gpu_test)."""
    return lambda loader: _forward_each_batch(model, 'forward_test', loader)


def make_feature_fn(model) -> Callable:
    """``feature_fn(loader) -> (videos, C)`` pooled features, the retrieval
    feature (reference recognizer3d.py:67-93)."""
    return lambda loader: np.stack(_forward_each_batch(
        model, 'extract_features_pooled', loader))


def run_test(model, loader) -> List[np.ndarray]:
    return make_eval_fn(model)(loader)


def extract_features(model, loader) -> np.ndarray:
    return make_feature_fn(model)(loader)


def retrieval_recall(train_feats: np.ndarray, train_labels,
                     test_feats: np.ndarray, test_labels,
                     topk=(1, 5, 10, 20, 50), device=None
                     ) -> Dict[str, float]:
    """kNN retrieval (reference test_retrival.py:286-304): center both sets
    by their joint mean and L2-normalise them (numpy, as the JAX function
    does), then on ``device`` (None: the card) sim = test @ train^T in
    float32 and its top-k train indices; Recall@k is the share of test
    videos with a top-k neighbour of their label."""
    device = resolve_device(device)
    train_labels = np.asarray(train_labels)
    test_labels = np.asarray(test_labels)
    mean = np.concatenate([train_feats, test_feats]).mean(
        axis=0, keepdims=True)
    tr = train_feats - mean
    te = test_feats - mean
    tr = tr / np.clip(np.linalg.norm(tr, axis=1, keepdims=True), 1e-12,
                      None)
    te = te / np.clip(np.linalg.norm(te, axis=1, keepdims=True), 1e-12,
                      None)
    max_k = min(max(topk), train_feats.shape[0])
    a, b = (torch.from_numpy(np.asarray(x, np.float32)).to(device)
            for x in (te, tr))
    idx = torch.topk(a @ b.T, max_k, dim=1).indices.cpu().numpy()
    hits = train_labels[idx] == test_labels[:, None]
    return {f'recall@{k}': float(hits[:, :min(k, max_k)].any(axis=1).mean())
            for k in topk}


def init_recognizer(config, checkpoint: Optional[str] = None, device=None):
    """A recognizer built from a config (a path or a Config) without its
    train_cfg, initialised from seed 0 on ``device`` (None: the card) and,
    given ``checkpoint`` (the port's or a reference ``.pth``), loaded
    from it (reference apis/inference.py:17-58). Returns (model, cfg)."""
    from ..config import Config
    from ..core import load_checkpoint, restore_model_state
    from .train import _plain, build_model_from_cfg
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    model_cfg = {k: v for k, v in _plain(cfg.model).items()
                 if k != 'train_cfg'}
    model = build_model_from_cfg(model_cfg, device=device)
    if checkpoint:
        restore_model_state(model, load_checkpoint(checkpoint))
    model.eval()
    return model, cfg


def inference_recognizer(model, cfg, video_path: str,
                         num_frames: Optional[int] = None):
    """Classify one rawframe directory (its frame files in name order)
    through the config's test pipeline (reference
    apis/inference.py:60-120). Returns (scores, top5 [(class, score)]). A
    video file would need cv2 to decode, which the port does not use:
    extract its frames to a directory first."""
    from ..datasets.builder import PIPELINES
    from ..registry import build_from_cfg
    from .train import _plain
    if not osp.isdir(video_path):
        raise NotImplementedError(
            f'{video_path} is not a rawframe directory: decoding a video '
            f'file needs cv2, which the port does not use; extract its '
            f'frames to a directory')
    frames = sorted(os.listdir(video_path))
    results = dict(start_index=cfg.get('start_index', 0), modality='RGB',
                   label=-1, frame_dir=video_path,
                   img_paths=[osp.join(video_path, f) for f in frames],
                   total_frames=num_frames or len(frames),
                   filename_tmpl=cfg.get('filename_tmpl', 'img_{:05}.jpg'))
    data = _plain(cfg.data)
    for tcfg in data['test' if 'test' in data else 'val']['pipeline']:
        results = build_from_cfg(dict(tcfg), PIPELINES)(results)
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            imgs = torch.from_numpy(np.asarray(results['imgs'])[None])
            scores = model.forward_test(imgs.to(device))[0].float().cpu()
    finally:
        model.train(was_training)
    scores = scores.numpy()
    top5 = sorted(enumerate(scores.tolist()), key=lambda kv: -kv[1])[:5]
    return scores, top5
