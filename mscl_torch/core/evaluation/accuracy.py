"""Evaluation metrics (numpy, host-side).

A copy of ``mscl_tpu/core/evaluation/accuracy.py`` (reference
mmaction/core/evaluation/accuracy.py:5-200: top_k_accuracy,
mean_class_accuracy, confusion_matrix, mean average precision); the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def confusion_matrix(y_pred, y_real, normalize=None):
    """Confusion matrix with optional 'true'/'pred'/'all' normalization."""
    if normalize not in ['true', 'pred', 'all', None]:
        raise ValueError("normalize must be one of {'true', 'pred', "
                         "'all', None}")
    y_pred = np.asarray(y_pred)
    y_real = np.asarray(y_real)
    if y_pred.dtype == np.int32:
        y_pred = y_pred.astype(np.int64)
    if y_real.dtype == np.int32:
        y_real = y_real.astype(np.int64)
    label_set = np.unique(np.concatenate((y_pred, y_real)))
    num_labels = len(label_set)
    max_label = label_set[-1]
    label_map = np.zeros(max_label + 1, dtype=np.int64)
    for i, label in enumerate(label_set):
        label_map[label] = i
    confusion_mat = np.zeros((num_labels, num_labels), dtype=np.int64)
    for rlabel, plabel in zip(y_real, y_pred):
        index_real = label_map[rlabel]
        index_pred = label_map[plabel]
        confusion_mat[index_real][index_pred] += 1
    if normalize is not None:
        confusion_mat = confusion_mat.astype(np.float64)
        m = confusion_mat
        if normalize == 'true':
            m = m / m.sum(axis=1, keepdims=True)
        elif normalize == 'pred':
            m = m / m.sum(axis=0, keepdims=True)
        elif normalize == 'all':
            m = m / m.sum()
        m = np.nan_to_num(m)
        confusion_mat = m
    return confusion_mat


def top_k_accuracy(scores, labels, topk=(1,)):
    """Fraction of samples whose label is within the top-k scores."""
    res = []
    labels = np.array(labels)[:, np.newaxis]
    for k in topk:
        max_k_preds = np.argsort(np.asarray(scores), axis=1)[:, -k:][:, ::-1]
        match_array = np.logical_or.reduce(max_k_preds == labels, axis=1)
        topk_acc_score = match_array.sum() / match_array.shape[0]
        res.append(topk_acc_score)
    return res


def mean_class_accuracy(scores, labels):
    """Mean over classes of per-class recall."""
    pred = np.argmax(np.asarray(scores), axis=1)
    cf_mat = confusion_matrix(pred, labels).astype(float)
    cls_cnt = cf_mat.sum(axis=1)
    cls_hit = np.diag(cf_mat)
    mean_class_acc = np.mean(
        [hit / cnt if cnt else 0.0 for cnt, hit in zip(cls_cnt, cls_hit)])
    return mean_class_acc


def per_class_accuracy(scores, labels):
    """Per-class recall vector plus the class ids (for the visualizer)."""
    pred = np.argmax(np.asarray(scores), axis=1)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    accs = []
    for c in classes:
        mask = labels == c
        accs.append(float((pred[mask] == c).mean()) if mask.any() else 0.0)
    return classes, np.array(accs)


def binary_precision_recall_curve(y_score, y_true):
    """Precision/recall pairs over all thresholds (for mAP)."""
    assert isinstance(y_score, np.ndarray)
    assert isinstance(y_true, np.ndarray)
    assert y_score.shape == y_true.shape
    desc_score_indices = np.argsort(y_score, kind='mergesort')[::-1]
    y_score = y_score[desc_score_indices]
    y_true = y_true[desc_score_indices]
    distinct_value_inds = np.where(np.diff(y_score))[0]
    threshold_inds = np.r_[distinct_value_inds, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_inds]
    fps = 1 + threshold_inds - tps
    thresholds = y_score[threshold_inds]
    precision = tps / (tps + fps)
    precision[np.isnan(precision)] = 0
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    return (np.r_[precision[sl], 1], np.r_[recall[sl], 0],
            thresholds[sl])


def mean_average_precision(scores, labels):
    """Multi-label mAP over classes."""
    results = []
    scores = np.stack(scores).T
    labels = np.stack(labels).T
    for score, label in zip(scores, labels):
        precision, recall, _ = binary_precision_recall_curve(score, label)
        ap = -np.sum(np.diff(recall) * np.array(precision)[:-1])
        results.append(ap)
    results = [x for x in results if not np.isnan(x)]
    if not results:
        return np.nan
    return np.mean(results)


def mmit_mean_average_precision(scores, labels):
    """Multi-moments-in-time style mAP: AP per sample, averaged."""
    results = []
    for score, label in zip(scores, labels):
        precision, recall, _ = binary_precision_recall_curve(
            np.asarray(score), np.asarray(label))
        ap = -np.sum(np.diff(recall) * np.array(precision)[:-1])
        results.append(ap)
    return np.mean(results)


def top_k_classes(scores, labels, k=10, mode='accurate'):
    """Most/least accurate K classes as (label_id, acc_ratio) pairs
    (reference accuracy.py:91-127)."""
    assert mode in ('accurate', 'inaccurate')
    pred = np.argmax(scores, axis=1)
    cf_mat = confusion_matrix(pred, labels).astype(float)
    cls_cnt = cf_mat.sum(axis=1)
    cls_hit = np.diag(cf_mat)
    hit_ratio = np.array([h / c if c else 0.0
                          for c, h in zip(cls_cnt, cls_hit)])
    if mode == 'accurate':
        idx = np.argsort(hit_ratio)[-k:][::-1]
    else:
        idx = np.argsort(hit_ratio)[:k]
    return list(zip(idx, hit_ratio[idx]))


def get_weighted_score(score_list, coeff_list):
    """Coefficient-weighted fusion of per-classifier score lists
    (reference accuracy.py:429-455)."""
    assert len(score_list) == len(coeff_list)
    num_samples = len(score_list[0])
    assert all(len(s) == num_samples for s in score_list)
    return [
        sum(np.array(score_list[i][n]) * coeff_list[i]
            for i in range(len(score_list)))
        for n in range(num_samples)
    ]
