"""Input flows, the port of ``InputData`` in
``multimodal_3d_image_segmentation_tpu/data/dataset.py``.

Sample ``i`` is read modality by modality, stacked channel-first,
normalized by ``x_processing``, paired with its label map when
``idx_y_modalities`` is set, and, in the training flow only, augmented
jointly by ``data/augmentation.py::ImageTransform``. ``num_workers > 0``
reads (and augments) ahead in a pool of spawned processes, about two
samples per worker; a flow keeps its pool for its lifetime, so a training
run starts its readers once, not once an epoch. For a given seed the
flows yield what the JAX package's flows yield: the shuffle comes from
the flow's seed, and with workers each task's augmentation seed is drawn
from the transform's generator in submission order.
"""
from __future__ import annotations

import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .augmentation import ImageTransform
from .nifti import read_img, read_shape

__all__ = ["InputData"]

_WORKER_DATASET = None


class _Dataset:
    def __init__(self, data_lists, reader, idx_x, idx_y, x_processing,
                 transform=None):
        self.data_lists = data_lists
        self.reader = reader
        self.idx_x = idx_x
        self.idx_y = idx_y
        self.x_processing = x_processing
        self.transform = transform

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
            return x if self.transform is None else self.transform(x)
        y = self._stack(self.idx_y, i)
        return (x, y) if self.transform is None else self.transform(x, y)


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(i, aug_seed=None):
    if aug_seed is not None:  # this task's own augmentation stream
        _WORKER_DATASET.transform.rng = np.random.default_rng(
            np.random.SeedSequence(aug_seed))
    return _WORKER_DATASET[i]


class _Flow:
    """Batches of one split, shuffled each pass when ``shuffle``;
    ``close`` stops the pool."""

    def __init__(self, dataset, batch_size, shuffle, num_workers,
                 seed=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self._rng = np.random.default_rng(seed)
        self._pool = None
        if num_workers and num_workers > 0:
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

    def _samples(self, order):
        n = len(order)
        if self._pool is None:
            for i in order:
                yield self.dataset[int(i)]
            return
        transform = self.dataset.transform
        aug_rng = None if transform is None else transform.rng

        def submit(k):
            seed = None if aug_rng is None else int(aug_rng.integers(2 ** 63))
            return self._pool.submit(_worker_get, int(order[k]), seed)

        window = min(n, max(2 * self.num_workers, self.batch_size))
        futures = [submit(k) for k in range(window)]
        for k in range(n):
            sample = futures[k].result()
            futures[k] = None
            if window < n:
                futures.append(submit(window))
                window += 1
            yield sample

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        batch = []
        for sample in self._samples(order):
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
    """The ``[input_args]`` facade of the reference: train, valid and test
    flows; shuffling and augmentation (``transform_kwargs``, the
    ``[augmentation]`` section) apply to the training flow only."""

    def __init__(self, reader=read_img, data_lists_train=None,
                 data_lists_valid=None, data_lists_test=None,
                 idx_x_modalities=None, idx_y_modalities=None,
                 x_processing=None, batch_size=1, num_workers=1,
                 transform_kwargs=None, seed=None):
        if idx_x_modalities is None:
            raise ValueError("[input_args] idx_x_modalities is required")
        self.reader = reader
        self.data_lists_train = data_lists_train
        self.data_lists_valid = data_lists_valid
        self.data_lists_test = data_lists_test
        self.idx_x_modalities = idx_x_modalities
        self.idx_y_modalities = idx_y_modalities
        self.x_processing = x_processing
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.transform_kwargs = transform_kwargs
        self.seed = seed

    def _get_flow(self, data_lists, shuffle=False, transform_kwargs=None):
        transform = (ImageTransform(**transform_kwargs)
                     if transform_kwargs is not None else None)
        return _Flow(
            _Dataset(data_lists, self.reader, self.idx_x_modalities,
                     self.idx_y_modalities, self.x_processing, transform),
            self.batch_size, shuffle, self.num_workers, seed=self.seed)

    def get_train_flow(self, shuffle=True):
        return self._get_flow(self.data_lists_train, shuffle=shuffle,
                              transform_kwargs=self.transform_kwargs)

    def get_valid_flow(self):
        return self._get_flow(self.data_lists_valid)

    def get_test_flow(self):
        return self._get_flow(self.data_lists_test)

    def _get_num_batches(self, data_lists):
        if data_lists is None:
            return 0
        return math.ceil(len(data_lists[0]) / self.batch_size)

    def get_train_num_batches(self):
        return self._get_num_batches(self.data_lists_train)

    def get_valid_num_batches(self):
        return self._get_num_batches(self.data_lists_valid)

    def get_test_num_batches(self):
        return self._get_num_batches(self.data_lists_test)

    def _get_image_size(self, data_lists):
        if data_lists is None:
            return None
        first = data_lists[0][0]
        if self.reader is read_img:
            return read_shape(first)  # header only, no full read
        return self.reader(first).shape

    def get_train_image_size(self):
        return self._get_image_size(self.data_lists_train)

    def get_valid_image_size(self):
        return self._get_image_size(self.data_lists_valid)

    def get_test_image_size(self):
        return self._get_image_size(self.data_lists_test)

    def get_num_x_modalities(self):
        return len(self.idx_x_modalities)
