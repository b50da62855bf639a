"""Metrics (counterpart of paddle_tpu/metrics.py): ``MetricBase``,
``CompositeMetric``, ``Precision``, ``Recall``, ``Accuracy``,
``ChunkEvaluator``, ``EditDistance``, ``Auc`` and ``DetectionMAP``. The
accumulators run in host numpy over fetched values, with the JAX package's
formulas; ``DetectionMAP`` builds the detection layers, which are ROADMAP
A.10 and raise naming it.
"""
from __future__ import annotations

import numpy as np

__all__ = ['MetricBase', 'CompositeMetric', 'Precision', 'Recall',
           'Accuracy', 'ChunkEvaluator', 'EditDistance', 'Auc',
           'DetectionMAP']


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith('_'):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0 if isinstance(v, int) else 0.0)

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith('_')}


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        d = self.tp + self.fn
        return float(self.tp) / d if d else 0.0


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        return self.value / self.weight if self.weight else 0.0


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        def first(x):
            return int(np.asarray(x).reshape(-1)[0])
        self.num_infer_chunks += first(num_infer_chunks)
        self.num_label_chunks += first(num_label_chunks)
        self.num_correct_chunks += first(num_correct_chunks)

    def eval(self):
        p = self.num_correct_chunks / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        r = self.num_correct_chunks / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * p * r / (p + r) if (p + r) else 0.0
        return p, r, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances).reshape(-1)
        self.total_distance += float(np.sum(d))
        self.seq_num += int(np.asarray(seq_num).reshape(-1)[0])
        self.instance_error += int(np.sum(d != 0))

    def eval(self):
        avg = self.total_distance / self.seq_num if self.seq_num else 0.0
        err = self.instance_error / self.seq_num if self.seq_num else 0.0
        return avg, err


class Auc(MetricBase):
    def __init__(self, name=None, curve='ROC', num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] >= 2 \
            else preds.reshape(-1)
        bins = np.minimum((pos_prob * self._num_thresholds).astype(np.int64),
                          self._num_thresholds)
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            p = self._stat_pos[i]
            n = self._stat_neg[i]
            auc += n * (tot_pos + p / 2.0)
            tot_pos += p
            tot_neg += n
        return auc / (tot_pos * tot_neg) if tot_pos * tot_neg else 0.0


class DetectionMAP:
    """Builds ``layers.detection_map`` on the current program; the
    detection layers are not ported yet (ROADMAP A.10), so it raises
    naming that item."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version='integral'):
        from . import layers
        self.cur_map, self.accum_map = layers.detection_map(
            input, gt_label, gt_box, class_num=class_num,
            background_label=background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version)

    def get_map_var(self):
        return self.cur_map, self.accum_map
