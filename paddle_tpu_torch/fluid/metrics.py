"""Pure-Python metric accumulators (reference python/paddle/fluid/metrics.py):
host-side state updated from fetched numpy values each step — complementary to
the in-graph metric ops (accuracy/auc/... emitters). A copy of
``paddle_tpu/fluid/metrics.py`` (numpy only)."""
from __future__ import annotations

import copy

import numpy as np

__all__ = [
    "MetricBase",
    "CompositeMetric",
    "Accuracy",
    "ChunkEvaluator",
    "EditDistance",
    "DetectionMAP",
    "Auc",
]


def _is_numpy_(var):
    return isinstance(var, (np.ndarray, np.generic))


def _is_number_(var):
    return isinstance(var, (int, float, np.number)) or (
        _is_numpy_(var) and var.size == 1
    )


def _is_number_or_matrix_(var):
    return _is_number_(var) or _is_numpy_(var)


class MetricBase:
    """State container: reset() zeroes every non-private attribute;
    update(...) folds a batch in; eval() returns the metric value."""

    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        for attr, value in states.items():
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, 0.0)
            elif isinstance(value, (np.ndarray, np.generic)):
                setattr(self, attr, np.zeros_like(value))
            else:
                setattr(self, attr, None)

    def get_config(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        config = {}
        config.update({"name": self._name, "states": copy.deepcopy(states)})
        return config

    def update(self, preds, labels):
        raise NotImplementedError()

    def eval(self):
        raise NotImplementedError()


class CompositeMetric(MetricBase):
    """Fan one (pred, label) stream into several metrics."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("metric should be a MetricBase")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    """Weighted running accuracy: update(batch_accuracy, batch_size)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        if not _is_number_or_matrix_(value):
            raise ValueError("value should be a number or a numpy array")
        if not _is_number_(weight):
            raise ValueError("weight should be a number")
        self.value += float(np.asarray(value).reshape(-1)[0]) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("accuracy has no data; call update() first")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """Chunking precision/recall/F1 from per-batch counts (reference feeds it
    the chunk_eval op's NumInferChunks/NumLabelChunks/NumCorrectChunks)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        for v in (num_infer_chunks, num_label_chunks, num_correct_chunks):
            if not _is_number_or_matrix_(v):
                raise ValueError("chunk counts must be numbers")
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).reshape(-1)[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).reshape(-1)[0])
        self.num_correct_chunks += int(
            np.asarray(num_correct_chunks).reshape(-1)[0]
        )

    def eval(self):
        precision = (
            float(self.num_correct_chunks) / self.num_infer_chunks
            if self.num_infer_chunks
            else 0.0
        )
        recall = (
            float(self.num_correct_chunks) / self.num_label_chunks
            if self.num_label_chunks
            else 0.0
        )
        f1_score = (
            2 * precision * recall / (precision + recall)
            if self.num_correct_chunks
            else 0.0
        )
        return precision, recall, f1_score


class EditDistance(MetricBase):
    """Average edit distance + instance error rate from the edit_distance op's
    (distances, seq_num) per batch."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        if not _is_numpy_(np.asarray(distances)):
            raise ValueError("distances should be a numpy array")
        distances = np.asarray(distances, dtype=np.float64)
        seq_num = int(np.asarray(seq_num).reshape(-1)[0])
        self.seq_num += seq_num
        self.instance_error += int(np.sum(distances > 0))
        self.total_distance += float(np.sum(distances))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data in EditDistance; call update() first")
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class DetectionMAP(MetricBase):
    """Running mean of per-batch mAP values (the in-graph detection_map op
    computes the per-batch value)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        if not _is_number_or_matrix_(value):
            raise ValueError("value should be a number or a numpy array")
        if not _is_number_(weight):
            raise ValueError("weight should be a number")
        self.value += float(np.asarray(value).reshape(-1)[0]) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("DetectionMAP has no data; call update() first")
        return self.value / self.weight


class Auc(MetricBase):
    """Streaming AUC over `num_thresholds` confusion-count bins; update() takes
    raw (preds, labels) with preds[:, 1] the positive-class score."""

    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._epsilon = 1e-6
        self.tp_list = np.zeros((num_thresholds,))
        self.fn_list = np.zeros((num_thresholds,))
        self.tn_list = np.zeros((num_thresholds,))
        self.fp_list = np.zeros((num_thresholds,))

    def update(self, preds, labels):
        if not _is_numpy_(np.asarray(labels)):
            raise ValueError("labels should be a numpy array")
        if not _is_numpy_(np.asarray(preds)):
            raise ValueError("preds should be a numpy array")
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1).astype(bool)
        pos_score = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        kepsilon = self._epsilon
        thresholds = [
            (i + 1) * 1.0 / (self._num_thresholds - 1)
            for i in range(self._num_thresholds - 2)
        ]
        thresholds = [0.0 - kepsilon] + thresholds + [1.0 + kepsilon]
        for idx_thresh, thresh in enumerate(thresholds):
            pred_pos = pos_score >= thresh
            self.tp_list[idx_thresh] += np.sum(pred_pos & labels)
            self.fp_list[idx_thresh] += np.sum(pred_pos & ~labels)
            self.fn_list[idx_thresh] += np.sum(~pred_pos & labels)
            self.tn_list[idx_thresh] += np.sum(~pred_pos & ~labels)

    def eval(self):
        epsilon = self._epsilon
        num_thresholds = self._num_thresholds
        tpr = (self.tp_list.astype("float32") + epsilon) / (
            self.tp_list + self.fn_list + epsilon
        )
        fpr = self.fp_list.astype("float32") / (
            self.fp_list + self.tn_list + epsilon
        )
        precision = (self.tp_list.astype("float32") + epsilon) / (
            self.tp_list + self.fp_list + epsilon
        )

        if self._curve == "PR":
            # integrate precision over recall (tpr == recall here)
            x = tpr[:num_thresholds - 1] - tpr[1:]
            y = (precision[:num_thresholds - 1] + precision[1:]) / 2.0
        else:
            x = fpr[:num_thresholds - 1] - fpr[1:]
            y = (tpr[:num_thresholds - 1] + tpr[1:]) / 2.0
        return np.sum(x * y)
