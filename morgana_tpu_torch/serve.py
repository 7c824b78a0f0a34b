"""Deployment inference: serve a trained checkpoint (counterpart of
``morgana_tpu/serve.py``, the predict part of :class:`InferenceEngine`).

    engine = InferenceEngine(LSTMAcousticModel, 'epoch_50.npz', data_root='data')
    outputs = engine.predict_ids(['utt_001', 'utt_002'])   # unpadded feature dicts

The checkpoint is the JAX package's ``epoch_{N}.npz``. Batches are padded
to the same length buckets as the training loader's. The engine runs on the
GPU unless built with ``device='cpu'``; on the GPU every LSTM layer of a
batch is one launch of kernel K1, every GRU layer one launch of K3.
"""
import os
import tempfile

import numpy as np
import torch

from morgana_tpu_torch import data
from morgana_tpu_torch.device import resolve_device

__all__ = ['InferenceEngine']


def _check_unique(names):
    """Results are keyed by utterance name; duplicates would overwrite each
    other's outputs."""
    seen = set()
    dupes = sorted({str(n) for n in names if str(n) in seen or seen.add(str(n))})
    if dupes:
        raise ValueError(f'duplicate utterance names: {dupes}')


class InferenceEngine(object):
    r"""Predict engine for one trained model.

    Parameters
    ----------
    model_class : type
        A :class:`~morgana_tpu_torch.base_models.BaseModel` subclass.
    checkpoint_path : str
        ``epoch_{N}.npz`` saved by the JAX package (names and shapes are
        checked strictly).
    data_root : str
        Root of the normalisation parameter files and data directories.
    normalisation_dir : str
        Sub-directory of ``data_root`` with the ``{name}_mvn/_minmax.json``
        files.
    model_kwargs : dict, optional
    device : str or torch.device, optional
        ``None`` means ``'cuda'`` and raises when no GPU is present; pass
        ``'cpu'`` to run on the CPU.
    batch_size : int
        Utterances per padded batch.
    """

    def __init__(self, model_class, checkpoint_path, data_root='.', normalisation_dir='train',
                 model_kwargs=None, device=None, batch_size=8):
        self.device = resolve_device(device)
        self.data_root = data_root
        self.checkpoint_path = checkpoint_path
        self.batch_size = int(batch_size)

        self.model = model_class(**(model_kwargs or {}))
        normalisers = self.model.normaliser_sources()
        for normaliser in normalisers.values():
            normaliser.load_params(normalisation_dir, data_root)
        self.model.normalisers = normalisers
        self._load_checkpoint_params(checkpoint_path)
        self.model.to(self.device).eval()

    def _load_checkpoint_params(self, checkpoint_path):
        """Copies the checkpoint's parameters into the model."""
        self.model.load_parameters(checkpoint_path)

    def predict_batch(self, features):
        """Runs ``predict`` on one collated (padded) batch: its numeric arrays
        go to the engine's device. Returns the output tensors, on device."""
        with torch.inference_mode():
            return self.model.predict(data.device_features(features, self.device))

    def _unpad(self, features, outputs):
        """Every (B, T_pad, D) output becomes a list of (t_i, D) numpy arrays
        cut at each utterance's ``n_frames``; other outputs become numpy
        arrays unchanged."""
        seq_len = features.get('n_frames')
        if seq_len is not None:
            seq_len = np.asarray(seq_len).astype(np.int64).reshape(-1)
        out = {}
        for key, value in outputs.items():
            arr = value.cpu().numpy()
            if seq_len is not None and arr.ndim >= 3 and arr.shape[0] == len(seq_len) \
                    and arr.shape[1] >= seq_len.max():
                out[key] = [arr[b, :seq_len[b]] for b in range(arr.shape[0])]
            else:
                out[key] = arr
        return out

    def _loader(self, data_dir, file_ids):
        # The ids go to a temporary id-list (never into data_root, which may
        # be read-only); the dataset reads it in its constructor.
        if not file_ids:
            raise ValueError('pass a non-empty file_ids list')
        fd, id_list = tempfile.mkstemp(suffix='.scp', prefix='serve_ids_')
        try:
            with os.fdopen(fd, 'w') as f:
                f.write('\n'.join(file_ids))
            dataset = data.FilesDataset(self.model.test_data_sources(), data_dir, id_list,
                                        self.model.normalisers, self.data_root)
        finally:
            os.unlink(id_list)
        return data.batch(dataset, batch_size=self.batch_size)

    def _collect(self, features, results):
        unpadded = self._unpad(features, self.predict_batch(features))
        for b, name in enumerate(features['name']):
            results[name] = {k: v[b] for k, v in unpadded.items()}

    def predict_items(self, items):
        """In-memory serving: ``items`` is a list of per-utterance dicts
        mapping each test data-source name to its raw feature (what that
        source's ``load_file`` returns); an optional ``'name'`` key labels the
        utterance. Deltas, normalisation and bucketed collation run as in the
        file pipeline. Returns ``{name: outputs}``, frame-level outputs
        unpadded."""
        names = [str(item.get('name', i)) for i, item in enumerate(items)]
        _check_unique(names)
        sources = self.model.test_data_sources()
        built = [data.assemble_item(sources, self.model.normalisers,
                                    lambda name, source, item=item: source.package(item[name]),
                                    name)
                 for item, name in zip(items, names)]
        results = {}
        for start in range(0, len(built), self.batch_size):
            self._collect(data.collate(built[start:start + self.batch_size]), results)
        return results

    def predict_ids(self, file_ids, data_dir='test'):
        """Predicts the given utterance ids of ``data_dir``; returns ``{id:
        outputs}``, frame-level outputs unpadded."""
        _check_unique(file_ids)
        results = {}
        for features in self._loader(data_dir, file_ids):
            self._collect(features, results)
        return results
