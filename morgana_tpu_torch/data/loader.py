"""In-order batching of a dataset (the part of ``morgana_tpu/data/loader.py``
that serving uses: no shuffle, no worker threads, no prefetch)."""

__all__ = ['batch']


def batch(dataset, batch_size=32):
    r"""Yields the dataset's items in order, ``batch_size`` at a time, as
    padded batches (``dataset.collate_fn``); the last batch may be short."""
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        yield dataset.collate_fn(items)
