"""Deployment inference: serve a trained checkpoint (counterpart of
``morgana_tpu/serve.py``: :class:`InferenceEngine`'s predict and generate
paths, and the command line for generation).

    engine = InferenceEngine(LSTMAcousticModel, 'epoch_50.npz', data_root='data')
    outputs = engine.predict_ids(['utt_001', 'utt_002'])   # unpadded feature dicts
    stats = engine.generate('out', data_dir='test',
                            id_list='test/test_file_id_list.scp')   # writes out/synth/*.wav

From the shell, ``python -m morgana_tpu_torch.serve --model
morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel --checkpoint_path
epoch_50.npz --data_root data --out_dir out [--device cpu]`` runs
:meth:`InferenceEngine.generate` and prints its stats as one JSON line.

The checkpoint is the JAX package's ``epoch_{N}.npz``. Batches are padded
to the same length buckets as the training loader's. The engine runs on the
GPU unless built with ``device='cpu'``; on the GPU every LSTM layer of a
batch is one launch of kernel K1, every GRU layer one launch of K3, every
attention block one of K5. Generation synthesises on the host, one
utterance at a time, after the batch's features are copied back.
"""
import argparse
import ast
import importlib
import importlib.util
import json
import os
import tempfile
import time

import numpy as np
import torch

from morgana_tpu_torch import data
from morgana_tpu_torch.device import resolve_device
from morgana_tpu_torch.utils import to_numpy

__all__ = ['InferenceEngine', 'load_model_class', 'main']


def load_model_class(spec):
    """Resolves ``'pkg.module:ClassName'`` or ``'path/to/file.py:ClassName'``
    (``serve.py:68``)."""
    if ':' not in spec:
        raise ValueError(f"--model must be 'module:Class' or 'file.py:Class', got {spec!r}")
    target, class_name = spec.rsplit(':', 1)
    if target.endswith('.py'):
        name = os.path.splitext(os.path.basename(target))[0]
        module_spec = importlib.util.spec_from_file_location(name, target)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
    else:
        module = importlib.import_module(target)
    return getattr(module, class_name)


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
    analysis_kwargs : dict, optional
        Keyword arguments of the model's test analysis hooks in
        :meth:`generate` (e.g. ``sample_rate``).
    """

    def __init__(self, model_class, checkpoint_path, data_root='.', normalisation_dir='train',
                 model_kwargs=None, device=None, batch_size=8, analysis_kwargs=None):
        self.device = resolve_device(device)
        self.data_root = data_root
        self.checkpoint_path = checkpoint_path
        self.batch_size = int(batch_size)
        self.analysis_kwargs = dict(analysis_kwargs or {})

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

    def _loader(self, data_dir, id_list=None, file_ids=None):
        """Batches of ``data_dir``'s utterances named by ``id_list`` (a file
        under ``data_root``) or else by ``file_ids``. The ids go to a
        temporary id-list (never into data_root, which may be read-only);
        the dataset reads it in its constructor."""
        tmp = None
        try:
            if id_list is None:
                if not file_ids:
                    raise ValueError('pass id_list or a non-empty file_ids list')
                fd, tmp = tempfile.mkstemp(suffix='.scp', prefix='serve_ids_')
                with os.fdopen(fd, 'w') as f:
                    f.write('\n'.join(file_ids))
                id_list = tmp
            dataset = data.FilesDataset(self.model.test_data_sources(), data_dir, id_list,
                                        self.model.normalisers, self.data_root)
        finally:
            if tmp:
                os.unlink(tmp)
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
        for features in self._loader(data_dir, file_ids=file_ids):
            self._collect(features, results)
        return results

    def _synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def generate(self, out_dir, data_dir='test', id_list=None, file_ids=None):
        """Predicts a whole split (``id_list`` under ``data_root``, or
        ``file_ids``) and runs the model's test analysis hooks into
        ``out_dir``: the acoustic models synthesise ``out_dir/synth/{name}.wav``
        (``serve.py:441-475``, the reference's ``run_test``).

        Returns the stats of the JAX engine: ``utterances`` (the names
        served), ``frames``, ``seconds``, ``frames_per_sec``, ``out_dir`` and,
        when the model keeps test metrics, ``metrics``; and
        ``split_seconds``, where those seconds went: ``load`` (reading and
        collating a batch), ``predict`` (on the device, synchronised),
        ``d2h`` (the outputs to the host) and ``analysis`` (the hooks: the
        vocoder and the wav files), one after the other."""
        loader = self._loader(data_dir, id_list=id_list, file_ids=file_ids)
        os.makedirs(out_dir, exist_ok=True)
        self.model.metrics.reset_state('test')
        utterances = 0
        frames = 0.0
        split = dict.fromkeys(('load', 'predict', 'd2h', 'analysis'), 0.0)
        start = last = time.perf_counter()
        for features in loader:
            marks = [time.perf_counter()]
            outputs = self.predict_batch(features)
            self._synchronize()
            marks.append(time.perf_counter())
            outputs = {key: to_numpy(value) for key, value in outputs.items()}
            marks.append(time.perf_counter())
            self.model.analysis_for_test_batch(features, outputs, out_dir, **self.analysis_kwargs)
            marks.append(time.perf_counter())
            for key, begin, end in zip(split, [last] + marks[:-1], marks):
                split[key] += end - begin
            last = marks[-1]
            if 'n_frames' in features:
                frames += float(np.asarray(features['n_frames']).sum())
            utterances += len(features['name'])
        self.model.analysis_for_test_epoch(out_dir, **self.analysis_kwargs)
        elapsed = time.perf_counter() - start
        stats = {'utterances': utterances, 'frames': int(frames),
                 'seconds': round(elapsed, 3),
                 'frames_per_sec': round(frames / elapsed, 1) if elapsed else 0.0,
                 'out_dir': out_dir, 'split_seconds': split}
        metrics = self.model.metrics.results_as_json_dict('test')
        if metrics:
            stats['metrics'] = metrics
        return stats


def main(argv=None):
    """Generation from the command line (``serve.py:931``, its generate
    path): builds an :class:`InferenceEngine`, runs :meth:`generate` over
    ``--data_dir`` and prints the stats as one JSON line. The JAX package's
    HTTP, fleet, quantisation, data-parallel, compute-dtype, streaming,
    loader-thread, hot-reload, dynamic-batching and compilation-cache flags
    are not ported: passing one is an argparse error."""
    parser = argparse.ArgumentParser(
        description='Generate wavs from a trained checkpoint with the PyTorch/CUDA port of '
                    'morgana_tpu.')
    parser.add_argument('--model', required=True,
                        help="Model class: 'pkg.module:Class' or 'file.py:Class'.")
    parser.add_argument('--checkpoint_path', required=True,
                        help='epoch_{N}.npz written by either package.')
    parser.add_argument('--data_root', default='.')
    parser.add_argument('--normalisation_dir', default='train')
    parser.add_argument('--data_dir', default='test')
    parser.add_argument('--id_list', default=None,
                        help='Id-list file (relative to --data_root). Defaults to the '
                             'conventional {data_dir}/{data_dir}_file_id_list.scp.')
    parser.add_argument('--out_dir', default='generated')
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--device', default=None,
                        help="'cuda' (the default; an error without a GPU), 'cuda:N' or 'cpu'.")
    parser.add_argument('--model_kwargs', default='{}',
                        help='Python-dict string of model constructor kwargs.')
    parser.add_argument('--analysis_kwargs', default='{}',
                        help='Python-dict string of analysis-hook kwargs.')
    args = parser.parse_args(argv)

    if args.id_list is None:
        base = os.path.basename(os.path.normpath(args.data_dir))
        candidate = os.path.join(args.data_dir, f'{base}_file_id_list.scp')
        if os.path.exists(os.path.join(args.data_root, candidate)):
            args.id_list = candidate
        else:
            parser.error(f'--id_list is required (no conventional id list at '
                         f'{os.path.join(args.data_root, candidate)})')

    engine = InferenceEngine(
        load_model_class(args.model), args.checkpoint_path, data_root=args.data_root,
        normalisation_dir=args.normalisation_dir,
        model_kwargs=ast.literal_eval(args.model_kwargs), device=args.device,
        batch_size=args.batch_size, analysis_kwargs=ast.literal_eval(args.analysis_kwargs))
    stats = engine.generate(args.out_dir, data_dir=args.data_dir, id_list=args.id_list)
    print(json.dumps(stats))


if __name__ == '__main__':
    main()
