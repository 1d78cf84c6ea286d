"""The test-split input flow, the port of ``InputData`` in
``multimodal_3d_image_segmentation_tpu/data/dataset.py``.

Sample ``i`` is read modality by modality, stacked channel-first,
normalized by ``x_processing`` and, with ``idx_y_modalities``, paired with
its label map. ``num_workers > 0`` reads ahead in a pool of spawned
processes, about two samples per worker. Training flows (shuffling,
augmentation) come with training (ROADMAP, Open items 1, item 7).
"""
from __future__ import annotations

import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .nifti import read_img, read_shape

__all__ = ["InputData"]

_WORKER_DATASET = None


class _Dataset:
    def __init__(self, data_lists, reader, idx_x, idx_y, x_processing):
        self.data_lists = data_lists
        self.reader = reader
        self.idx_x = idx_x
        self.idx_y = idx_y
        self.x_processing = x_processing

    def __len__(self):
        return len(self.data_lists[0])

    def _stack(self, modalities, i):
        return np.stack([self.reader(self.data_lists[m][i])
                         for m in modalities])

    def __getitem__(self, i):
        x = self._stack(self.idx_x, i)
        if self.x_processing is not None:
            x = self.x_processing(x)
        if self.idx_y is None:
            return x
        return x, self._stack(self.idx_y, i)


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(i):
    return _WORKER_DATASET[i]


class _TestFlow:
    """Batches of the test split in order; ``close`` stops the pool."""

    def __init__(self, dataset, batch_size, num_workers):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self._pool = None
        if num_workers > 0:
            self._pool = ProcessPoolExecutor(
                max_workers=num_workers, initializer=_worker_init,
                initargs=(dataset,),
                mp_context=multiprocessing.get_context("spawn"))

    def __len__(self):
        return math.ceil(len(self.dataset) / self.batch_size)

    @staticmethod
    def _collate(samples):
        if isinstance(samples[0], tuple):
            xs, ys = zip(*samples)
            return np.stack(xs), np.stack(ys)
        return np.stack(samples)

    def _samples(self):
        n = len(self.dataset)
        if self._pool is None:
            for i in range(n):
                yield self.dataset[i]
            return
        window = min(n, max(2 * self.num_workers, self.batch_size))
        futures = [self._pool.submit(_worker_get, i) for i in range(window)]
        for i in range(n):
            sample = futures[i].result()
            futures[i] = None
            if window < n:
                futures.append(self._pool.submit(_worker_get, window))
                window += 1
            yield sample

    def __iter__(self):
        batch = []
        for sample in self._samples():
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(batch)
                batch = []
        if batch:
            yield self._collate(batch)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


class InputData:
    """The ``[input_args]`` facade of the reference, for the test split."""

    def __init__(self, reader=read_img, data_lists_test=None,
                 idx_x_modalities=None, idx_y_modalities=None,
                 x_processing=None, batch_size=1, num_workers=1):
        if idx_x_modalities is None:
            raise ValueError("[input_args] idx_x_modalities is required")
        self.reader = reader
        self.data_lists_test = data_lists_test
        self.idx_x_modalities = idx_x_modalities
        self.idx_y_modalities = idx_y_modalities
        self.x_processing = x_processing
        self.batch_size = batch_size
        self.num_workers = num_workers

    def get_test_flow(self):
        return _TestFlow(
            _Dataset(self.data_lists_test, self.reader,
                     self.idx_x_modalities, self.idx_y_modalities,
                     self.x_processing),
            self.batch_size, self.num_workers)

    def get_test_num_batches(self):
        if self.data_lists_test is None:
            return 0
        return math.ceil(len(self.data_lists_test[0]) / self.batch_size)

    def get_test_image_size(self):
        if self.data_lists_test is None:
            return None
        first = self.data_lists_test[0][0]
        if self.reader is read_img:
            return read_shape(first)  # header only, no full read
        return self.reader(first).shape

    def get_num_x_modalities(self):
        return len(self.idx_x_modalities)
