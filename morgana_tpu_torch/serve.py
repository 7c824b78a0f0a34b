"""Deployment inference: serve a trained checkpoint (counterpart of
``morgana_tpu/serve.py``: :class:`InferenceEngine`, :class:`StreamingSession`,
:class:`DynamicBatcher` and the command line).

    engine = InferenceEngine(LSTMAcousticModel, 'epoch_50.npz', data_root='data')
    outputs = engine.predict_ids(['utt_001', 'utt_002'])   # unpadded feature dicts
    stats = engine.generate('out', data_dir='test',
                            id_list='test/test_file_id_list.scp')   # writes out/synth/*.wav

From the shell, ``python -m morgana_tpu_torch.serve --model
morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel --checkpoint_path
epoch_50.npz --data_root data --out_dir out [--device cpu]`` runs
:meth:`InferenceEngine.generate` and prints its stats as one JSON line; with
``--http_port`` it serves the checkpoint over HTTP instead
(:mod:`morgana_tpu_torch.http_serve`: ``/predict`` through a
:class:`DynamicBatcher`, ``/stream``, ``/healthz``, ``/stats``), one voice or
a ``--fleet`` of them, with ``--watch_checkpoints`` hot reload.

The checkpoint is the JAX package's ``epoch_{N}.npz``, or a quantized one
(:mod:`morgana_tpu_torch.quantize`); ``quantize='int8'|'int4'`` serves a
float checkpoint quantized. Batches are padded to the same length buckets as
the training loader's. The engine runs on the GPU unless built with
``device='cpu'``; on the GPU every LSTM layer of a batch is one launch of
kernel K1, every GRU layer one launch of K3, every attention block one of K5.
``compute_dtype='bfloat16'`` serves in bf16 (``nn.set_default_compute_dtype``):
the dense products as bf16 GEMMs with f32 sums, and the same kernels in their
bf16-compute builds, K1c, K3c and K5b.
Generation synthesises on the host, one utterance at a time, after the
batch's features are copied back.

Each parameter version is a model instance of its own (:attr:`InferenceEngine.model`):
:meth:`~InferenceEngine.reload_checkpoint` builds the next one beside it and
swaps the reference, so a call in flight, or a stream, finishes on the
version it started with.

A model with the streaming hooks also streams one utterance chunk by chunk
(:meth:`InferenceEngine.stream_item`, :meth:`~InferenceEngine.stream_id`,
:class:`StreamingSession`), to features or, with
:meth:`~InferenceEngine.stream_item_audio`, to audio.
"""
import argparse
import ast
import contextlib
import importlib
import importlib.util
import json
import os
import re
import tempfile
import threading
import time

import numpy as np
import torch

from morgana_tpu_torch import _build
from morgana_tpu_torch import checkpointing
from morgana_tpu_torch import data
from morgana_tpu_torch import nn
from morgana_tpu_torch import quantize as quantize_mod
from morgana_tpu_torch.device import resolve_device
from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.ops.deltas import DEFAULT_WINDOWS
from morgana_tpu_torch.streaming import StreamingMLPG
from morgana_tpu_torch.utils import to_numpy

__all__ = ['InferenceEngine', 'StreamingSession', 'DynamicBatcher', 'Overloaded',
           'load_model_class', 'load_exported_program', 'numeric_features', 'program_inputs',
           'main']


class Overloaded(RuntimeError):
    """Raised by :class:`DynamicBatcher` when its queue of pending requests is
    full (``serve.py:46``): backpressure, which the HTTP layer answers with
    503."""


def numeric_features(features):
    """The numeric (and boolean) arrays of a collated batch, by sorted key
    (``training.py:178``): what a predict program takes. Names and other
    host values are left out."""
    return {key: value for key, value in sorted(features.items())
            if isinstance(value, torch.Tensor)
            or isinstance(value, np.ndarray) and value.dtype.kind in 'fiub'}


def program_inputs(params):
    """A ``{name: tensor | QuantizedArray | Int4QuantizedArray}`` dict as
    the tensors a predict program takes, by sorted key, each named as the
    JAX package's checkpoint files name it: a float leaf by its name, a
    quantized one as ``{name}.q`` (int8) or ``{name}.q4`` (packed int4) and
    ``{name}.scale``."""
    return _program_layout(params)[0]


def _program_layout(params):
    """``(program_inputs(params), {input name: the model's parameter
    name})``: a quantized weight's two tensors are its parametrization's
    ``original0`` and ``original1``."""
    inputs, names = {}, {}
    for name, value in params.items():
        if isinstance(value, (quantize_mod.QuantizedArray, quantize_mod.Int4QuantizedArray)):
            owner, _, attr = name.rpartition('.')
            base = f'{owner}.parametrizations.{attr}' if owner else f'parametrizations.{attr}'
            packed = 'q4' if isinstance(value, quantize_mod.Int4QuantizedArray) else 'q'
            for suffix, tensor, original in ((packed, value.tensors()[0], 'original0'),
                                             ('scale', value.tensors()[1], 'original1')):
                inputs[f'{name}.{suffix}'] = tensor
                names[f'{name}.{suffix}'] = f'{base}.{original}'
        else:
            inputs[name], names[name] = value, name
    return dict(sorted(inputs.items())), names


def _served_params(model):
    """The served version's parameters by JAX name: a float tensor, or the
    :class:`~morgana_tpu_torch.quantize.QuantizedArray` (or int4) that a
    quantized weight's parametrization holds (its tensors, not copies)."""
    out = {}
    for name, value in model.named_parameters():
        parts = name.split('.')
        if 'parametrizations' not in parts:
            out[name] = value
            continue
        at = parts.index('parametrizations')
        owner, attr = '.'.join(parts[:at]), parts[at + 1]
        weight = f'{owner}.{attr}' if owner else attr
        if weight in out:
            continue
        originals = model.get_submodule(owner).parametrizations[attr]
        deq = originals[0]
        q, scale = originals.original0, originals.original1
        out[weight] = (quantize_mod.Int4QuantizedArray(q, scale, deq.rows, deq.group_size,
                                                       deq.float_dtype) if deq.int4
                       else quantize_mod.QuantizedArray(q, scale, deq.float_dtype))
    return out


class _Predict(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.predict(batch)


class _PredictStep(torch.nn.Module):
    """The engine's predict step as a function of ``(params, batch)``, the
    model's parameters taken from ``params`` (by :func:`program_inputs`'
    names) through ``torch.func.functional_call``: the module holds no
    tensor of its own, so an exported program holds no parameter and takes
    them as inputs. Returns ``(staged, outputs)``; ``staged`` is the JAX
    step's staged metric partials, and the port's models stage none in
    ``predict`` (their metrics accumulate in ``loss``), so it is ``{}``."""

    def __init__(self, model, names):
        super().__init__()
        self.__dict__['_predict'] = _Predict(model)   # not a submodule
        self._names = names

    def forward(self, params, batch):
        outputs = torch.func.functional_call(
            self._predict, {f'model.{self._names[key]}': value for key, value in params.items()},
            (batch,))
        return {}, outputs


def load_exported_program(path):
    """Loads an :meth:`InferenceEngine.export_program` artifact
    (``serve.py:51``) and returns it as a callable ``fn(params, batch,
    rng=None) -> (staged, outputs)``: ``params`` as :func:`program_inputs`
    gives them and ``batch`` the numeric features, both tensors on the
    device the program was exported on. No model class, data source or
    normaliser is needed, only this package for the kernels' custom ops;
    ``rng`` is accepted for the JAX signature and not read (the port's
    predict step draws no noise)."""
    from morgana_tpu_torch.ops import flash_attention, gru, lstm, mlpg  # noqa: F401 - the ops

    program = torch.export.load(path).module()

    def run(params, batch, rng=None):
        with torch.no_grad():
            return program(dict(sorted(params.items())), dict(sorted(batch.items())))
    return run


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
        ``epoch_{N}.npz`` saved by either package, or a quantized checkpoint
        of either (:mod:`morgana_tpu_torch.quantize`), detected and served
        quantized; names and shapes are checked strictly.
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
    num_data_threads : int
        Threads that read a batch's items from disk (0 reads them inline;
        ``serve.py:135``).
    analysis_kwargs : dict, optional
        Keyword arguments of the model's test analysis hooks in
        :meth:`generate` (e.g. ``sample_rate``).
    stream_configs : list of (chunk_frames, context, lookahead), optional
        The stream configurations that the HTTP ``/stream`` endpoint serves
        (default ``[(64, 32, 16)]``): the operator chooses them, not the
        client (``serve.py:158-163``).
    quantize : {None, 'int8', 'int4'}
        Serve the weights that :func:`~morgana_tpu_torch.quantize.default_should_quantize`
        picks quantized: per-channel int8, or packed int4 with group-wise
        scales. Only the quantized tensors stay on the device; each layer
        reads its weight dequantised at each call.
    compilation_cache_dir : str, optional
        Where the kernels' libraries are built and found
        (:func:`morgana_tpu_torch._build.set_build_dir`), for every engine
        of the process: a new process that finds them there runs no
        compiler (``serve.py:166``, the JAX package's persistent XLA cache).
    compute_dtype : {None, 'float32', 'bfloat16'}
        When given, sets the process's compute dtype
        (:func:`morgana_tpu_torch.nn.set_default_compute_dtype`,
        ``serve.py:143-144``), which every engine of the process then
        serves in: 'bfloat16' rounds the inputs of every product to bf16,
        with f32 sums; the stored parameters do not change. None leaves it
        as it is.

    Attributes
    ----------
    model : BaseModel
        The parameter version being served, one model instance; every call
        reads it once when it starts. :meth:`reload_checkpoint` replaces it
        whole.
    """

    def __init__(self, model_class, checkpoint_path, data_root='.', normalisation_dir='train',
                 model_kwargs=None, device=None, batch_size=8, analysis_kwargs=None,
                 stream_configs=None, quantize=None, compilation_cache_dir=None,
                 compute_dtype=None, num_data_threads=0):
        if quantize not in (None, 'int8', 'int4'):
            raise ValueError(f"quantize must be None, 'int8' or 'int4', got {quantize!r}")
        if compute_dtype:
            nn.set_default_compute_dtype(compute_dtype)
        if compilation_cache_dir:
            _build.set_build_dir(compilation_cache_dir)
        self.device = resolve_device(device)
        self.data_root = data_root
        self.batch_size = int(batch_size)
        self.num_data_threads = int(num_data_threads)
        self.analysis_kwargs = dict(analysis_kwargs or {})
        self.stream_configs = {tuple(int(v) for v in cfg)
                               for cfg in (stream_configs or [(64, 32, 16)])}
        self._model_class = model_class
        self._model_kwargs = dict(model_kwargs or {})
        self._quantize = quantize

        self.model = self._build_model(checkpoint_path)
        self._normalisers = data.Normalisers(self.model.normaliser_sources(), normalisation_dir,
                                             data_root)
        self.model.normalisers = self._normalisers
        self.checkpoint_path = checkpoint_path

    def _build_model(self, checkpoint_path):
        """A model instance holding one checkpoint's parameters on the
        engine's device (quantized as the checkpoint or the engine's mode
        says), in eval mode. Raises, and touches nothing the engine serves,
        when the checkpoint does not match the model."""
        # Made on the meta device, then given storage that the checkpoint
        # fills: no random init, which a reload would spend in the host's
        # time under serving load.
        with torch.device('meta'):
            model = self._model_class(**self._model_kwargs)
        model.to_empty(device='cpu')
        if quantize_mod.is_quantized_checkpoint(checkpoint_path):
            params = quantize_mod.load_quantized_checkpoint(checkpoint_path)
        else:
            params = checkpointing.load_state_dict(checkpoint_path)
        if self._quantize:
            params = quantize_mod.quantize_params(params,
                                                  bits={'int8': 8, 'int4': 4}[self._quantize])
        quantize_mod.load_params(model, params)
        return self._to_device(model).eval()

    def _to_device(self, model):
        """``model`` on the engine's device. On the GPU its copies run on a
        stream of their own: a copy from pageable memory waits for the
        earlier work of its stream, and on the served calls' stream a reload
        under load would wait behind every batch in flight, a copy at a
        time. The tensors are then marked as used on the served stream."""
        if self.device.type != 'cuda':
            return model.to(self.device)
        side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(side):
            model = model.to(self.device)
        side.synchronize()
        served = torch.cuda.current_stream(self.device)
        for tensor in list(model.parameters()) + list(model.buffers()):
            tensor.record_stream(served)
        return model

    @property
    def quantized(self):
        """True when the served version holds quantized weights."""
        return quantize_mod.is_quantized(self.model)

    def reload_checkpoint(self, checkpoint_path):
        """Serves another checkpoint of the same architecture
        (``serve.py:224-239``): the new version is built beside the old one,
        with the engine's normalisers and quantize mode, and then replaces it
        in one assignment. Calls and streams in flight finish on the version
        they started with. A checkpoint that does not match raises, and the
        old version goes on serving. Returns ``checkpoint_path``."""
        model = self._build_model(checkpoint_path)
        model.normalisers = self._normalisers
        self.model = model
        self.checkpoint_path = checkpoint_path
        return checkpoint_path

    def maybe_reload_newer_checkpoint(self):
        """Reloads the highest-epoch sibling of the served checkpoint with the
        same ``epoch_{N}`` file name pattern (``serve.py:241-266``; an
        ``epoch_9_ema.npz`` does not match ``epoch_1.npz``). Returns the path
        reloaded, or None when nothing newer is there."""
        newer = self.newer_checkpoint()
        return None if newer is None else self.reload_checkpoint(newer)

    def newer_checkpoint(self):
        """The highest-epoch sibling of the served checkpoint that
        :meth:`maybe_reload_newer_checkpoint` would reload, or None."""
        match = re.match(r'^(.*epoch_)(\d+)(\D.*\.npz|\.npz)$',
                         os.path.basename(self.checkpoint_path))
        if not match:
            return None
        prefix, current, suffix = match.group(1), int(match.group(2)), match.group(3)
        ckpt_dir = os.path.dirname(self.checkpoint_path) or '.'
        try:
            names = os.listdir(ckpt_dir)
        except OSError:
            return None
        best, best_epoch = None, current
        for name in names:
            m = re.match(rf'^{re.escape(prefix)}(\d+){re.escape(suffix)}$', name)
            if m and int(m.group(1)) > best_epoch:
                best_epoch, best = int(m.group(1)), os.path.join(ckpt_dir, name)
        return best

    def predict_batch(self, features):
        """Runs ``predict`` on one collated (padded) batch: its numeric arrays
        go to the engine's device. Returns the output tensors, on device."""
        return self._predict(self.model, features)

    def _predict(self, model, features):
        with torch.inference_mode():
            return model.predict(data.device_features(features, self.device))

    def served_params(self):
        """The served version's parameters by JAX name: float tensors, and
        the :class:`~morgana_tpu_torch.quantize.QuantizedArray` (or int4)
        of each quantized weight; on the engine's device."""
        return _served_params(self.model)

    def program_params(self):
        """The served version's parameters as a predict program's inputs
        (:func:`program_inputs`), on the engine's device."""
        return program_inputs(self.served_params())

    def export_program(self, features, path):
        """Exports the predict step for this batch's padded shapes
        (``serve.py:298``) as a ``torch.export`` program, saved to ``path``:
        the network, the staged metrics and MLPG, each kernel one
        ``morgana::`` custom-op node, with the parameters as inputs (never
        baked in). :func:`load_exported_program` runs it without the
        model's class, data sources or normalisers, on the engine's device
        (a program is specific to it, as a JAX one to its platform), given
        :meth:`program_params` and batches of the same shapes and types.
        ``features`` is one collated batch; its values are not kept.
        Returns ``path``."""
        model = self.model
        inputs, names = _program_layout(_served_params(model))
        step = _PredictStep(model, names)
        batch = {key: torch.as_tensor(value).to(self.device)
                 for key, value in numeric_features(features).items()}
        # One real call first: the normalisers' statistics it puts on the
        # device become the program's constants there, not copies made at
        # each call.
        self._predict(model, features)
        with torch.no_grad():
            program = torch.export.export(step, (inputs, batch), strict=False)
        program.example_inputs = None   # else saved with it: the weights and a batch
        torch.export.save(program, path)
        return path

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

    def _loader(self, data_dir, id_list=None, file_ids=None, sources=None):
        """Batches of ``data_dir``'s utterances named by ``id_list`` (a file
        under ``data_root``) or else by ``file_ids``, read by ``sources``
        (default: the model's test data sources), moved to the engine's
        device ahead of their use by the prefetching loader
        (``serve.py:376``). The ids go to a
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
            dataset = data.FilesDataset(sources or self.model.test_data_sources(), data_dir,
                                        id_list, self._normalisers, self.data_root)
        finally:
            if tmp:
                os.unlink(tmp)
        return data.batch(dataset, batch_size=self.batch_size,
                          num_data_threads=self.num_data_threads, device=self.device)

    def _collect(self, model, features, results):
        outputs = self._predict(model, features)
        features = data.host_features(features)
        unpadded = self._unpad(features, outputs)
        for b, name in enumerate(features['name']):
            results[name] = {k: v[b] for k, v in unpadded.items()}

    def _assemble(self, item, name, sources):
        return data.assemble_item(sources or self.model.test_data_sources(), self._normalisers,
                                  lambda key, source: source.package(item[key]), name)

    def predict_items(self, items, sources=None):
        """In-memory serving: ``items`` is a list of per-utterance dicts
        mapping each data-source name to its raw feature (what that source's
        ``load_file`` returns); an optional ``'name'`` key labels the
        utterance. Deltas, normalisation and bucketed collation run as in the
        file pipeline. Returns ``{name: outputs}``, frame-level outputs
        unpadded; every batch runs on the version served when the call began.

        ``sources`` replaces the model's test data sources, e.g. by the
        subset that holds ``predict``'s true inputs, so that a generation
        caller (``pipeline.TTSPipeline``) need not make up training
        targets."""
        model = self.model
        names = [str(item.get('name', i)) for i, item in enumerate(items)]
        _check_unique(names)
        built = [self._assemble(item, name, sources) for item, name in zip(items, names)]
        results = {}
        for start in range(0, len(built), self.batch_size):
            self._collect(model, data.collate(built[start:start + self.batch_size]), results)
        return results

    def predict_ids(self, file_ids, data_dir='test'):
        """Predicts the given utterance ids of ``data_dir``; returns ``{id:
        outputs}``, frame-level outputs unpadded."""
        model = self.model
        _check_unique(file_ids)
        results = {}
        for features in self._loader(data_dir, file_ids=file_ids):
            self._collect(model, features, results)
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
            features = data.host_features(features)
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

    # ----------------------------------------------------------- streaming

    def _stream_session(self, chunk_frames, context, lookahead):
        """A :class:`StreamingSession` for one chunk configuration on the
        version served now, which the stream keeps to its last chunk
        (``serve.py:641-647``). It holds no compiled program, so nothing is
        kept between calls."""
        return StreamingSession(self, chunk_frames=chunk_frames, context=context,
                                lookahead=lookahead, model=self.model)

    def stream_item(self, item, chunk_frames=64, context=32, lookahead=16, sources=None):
        """Streams one in-memory utterance (an item of :meth:`predict_items`):
        a generator of ``{name: (new_frames, D) array}`` chunks. The model
        must implement the streaming hooks; ``sources`` as in
        :meth:`predict_items`."""
        features = data.collate([self._assemble(item, str(item.get('name', 0)), sources)])
        return self._stream_session(chunk_frames, context, lookahead).stream(features)

    def stream_id(self, file_id, data_dir='test', chunk_frames=64, context=32, lookahead=16):
        """Streams one utterance of ``data_dir`` by id; see :meth:`stream_item`."""
        features = data.host_features(next(iter(self._loader(data_dir, file_ids=[file_id]))))
        return self._stream_session(chunk_frames, context, lookahead).stream(features)

    def stream_item_audio(self, item, chunk_frames=64, context=32, lookahead=16,
                          sample_rate=16000, frame_period=5.0, sources=None, device_lock=None):
        """Streams one utterance to audio (``serve.py:515-587``): yields
        ``(feature_chunk, wav_chunk)`` pairs, ``wav_chunk`` the float64
        samples that chunk finalises (possibly empty while the vocoder's
        excitation window fills; the last pair carries the flush). The
        model's streamed outputs must cover lf0, vuv, mcep and bap.

        The wave is the NumPy host synthesis of the streamed features
        (:class:`morgana_tpu_torch.vocoder.StreamingSynthesizer`, seed 0),
        without that path's global clip-protection rescale, which needs the
        whole signal's peak. Unlike the analysis hooks, f0 is not smoothed
        (the filter needs future frames): it is ``exp(lf0)`` with lf0
        clipped at 8 (about 3 kHz).

        ``device_lock`` (optional): a lock held around each chunk of the
        model only; the vocoder runs outside it."""
        from morgana_tpu_torch.vocoder import StreamingSynthesizer

        session = self._stream_session(chunk_frames, context, lookahead)
        needed = {'lf0', 'vuv', 'mcep', 'bap'}
        if not needed <= set(session.spec):
            raise ValueError(
                f'audio streaming needs streamed outputs {sorted(needed)}; '
                f'{type(session.model).__name__} streams {sorted(session.spec)} '
                '(use stream_item for feature-only streaming)')
        synth = StreamingSynthesizer(sample_rate, frame_period=frame_period, seed=0)
        # Assembled here, not at the first next(): a missing feature raises
        # before the caller commits to a streamed response.
        feature_stream = iter(self.stream_item(item, chunk_frames=chunk_frames, context=context,
                                               lookahead=lookahead, sources=sources))
        lock = contextlib.nullcontext() if device_lock is None else device_lock

        def generate():
            chunk = None
            while True:
                with lock:
                    got = next(feature_stream, None)
                if got is None:
                    break
                chunk = got
                f0 = np.exp(np.clip(chunk['lf0'][:, 0], None, 8.0))
                yield chunk, synth.push_world_feats(f0, chunk['vuv'][:, 0], chunk['mcep'],
                                                    chunk['bap'])
            tail = synth.flush()
            if tail.shape[0]:
                yield ({} if chunk is None else {k: v[:0] for k, v in chunk.items()}), tail

        return generate()


class StreamingSession(object):
    """Chunked streaming inference (``serve.py:590-749``): the time to the
    first frame does not grow with the utterance.

    The model's :meth:`stream_inputs` run once on the engine's device; then
    each chunk of ``chunk_frames`` frames (the last one zero-padded) runs
    ``stream_step`` under ``torch.inference_mode()``, its recurrent state or
    KV caches kept on the device between chunks. One copy a chunk brings
    the outputs that the stream emits to the host, where the MLPG streams
    that share a burn-in are fused into one
    :class:`~morgana_tpu_torch.streaming.StreamingMLPG` windowed solve a
    chunk. Emission is aligned across the outputs, ``lookahead`` frames
    behind. On the GPU every LSTM layer of a chunk is one launch of K1 (K1c
    in bf16) with the carried state, every GRU layer one of K3; the
    attention step is the plain attention over the cache, as in JAX.

    Each :meth:`stream` call is an independent generator. A session runs on
    ``model``, the engine's version when it was made by default, to the end
    of each stream, whatever the engine reloads meanwhile.
    """

    def __init__(self, engine, chunk_frames=64, context=32, lookahead=16, model=None):
        self.engine = engine
        self.model = engine.model if model is None else model
        self.chunk_frames = int(chunk_frames)
        self.context = int(context)
        self.lookahead = int(lookahead)
        self.spec = self.model.stream_output_spec()

    def _mlpg_groups(self):
        """The MLPG outputs grouped by burn-in: ``[(members, StreamingMLPG)]``
        with members ``(name, means_key, dim)``; each group's lanes are
        concatenated inside each delta window and solved together."""
        num_windows = len(DEFAULT_WINDOWS)
        groups = {}
        for name, spec in self.spec.items():
            if spec is None:
                continue
            means_key, variances, padding_size = spec
            variances = np.asarray(variances, np.float32).reshape(num_windows, -1)
            groups.setdefault(int(padding_size), []).append((name, means_key, variances))
        return [([(name, key, v.shape[1]) for name, key, v in members],
                 StreamingMLPG(np.concatenate([v for _, _, v in members], axis=1).reshape(-1),
                               self.chunk_frames, context=self.context,
                               lookahead=self.lookahead, padding_size=padding_size))
                for padding_size, members in groups.items()]

    def stream(self, features):
        """A generator over one collated one-utterance batch: yields
        ``{name: (new_frames, D) np.ndarray}``, every dict covering the same
        frames for every name of the model's ``stream_output_spec``."""
        engine, model = self.engine, self.model
        batch = data.device_features(features, engine.device)
        with torch.inference_mode():
            inputs = model.stream_inputs(batch)
        if inputs.shape[0] != 1:
            raise ValueError('streaming serves one utterance per session; '
                             f'got a batch of {inputs.shape[0]}')
        if 'n_frames' in features:
            n_frames = int(np.asarray(features['n_frames']).reshape(-1)[0])
        else:
            n_frames = inputs.shape[1]

        num_windows = len(DEFAULT_WINDOWS)
        chunk_size = self.chunk_frames
        mlpg_groups = self._mlpg_groups()
        # The outputs the stream reads, in one (chunk, D) host copy a chunk.
        keys = [name for name, spec in self.spec.items() if spec is None] + \
            [key for members, _ in mlpg_groups for _, key, _ in members]
        buffers = {name: [] for name in self.spec}

        def drain():
            """The frames every output has, cut from the buffers."""
            ready = min(sum(a.shape[0] for a in parts) for parts in buffers.values())
            if ready == 0:
                return None
            out = {}
            for name, parts in buffers.items():
                whole = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
                out[name], buffers[name] = whole[:ready], [whole[ready:]]
            return out

        def emit(got, members):
            if not got.shape[1]:
                return
            offset = 0
            for name, _, dim in members:
                buffers[name].append(got[0, :, offset:offset + dim])
                offset += dim

        emitted = 0
        state = None
        for start in range(0, n_frames, chunk_size):
            valid = min(chunk_size, n_frames - start)
            with torch.inference_mode():
                chunk = inputs[:, start:start + valid]
                if valid < chunk_size:
                    # The final partial chunk is zero-padded; only the
                    # carried state, which ends here, sees the padding.
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (1, chunk_size - valid) + tuple(chunk.shape[2:]))], dim=1)
                outputs, state = model.stream_step(chunk, state)
                host = torch.cat([outputs[key][0, :valid] for key in keys],
                                 dim=-1).cpu().numpy()
            split = dict(zip(keys, np.split(host, np.cumsum(
                [outputs[key].shape[-1] for key in keys])[:-1], axis=-1)))
            for name, spec in self.spec.items():
                if spec is None:
                    buffers[name].append(split[name])
            for members, streaming_mlpg in mlpg_groups:
                means = np.concatenate([split[key].reshape(valid, num_windows, dim)
                                        for _, key, dim in members], axis=2)
                emit(streaming_mlpg.push(means.reshape(1, valid, -1)), members)
            out = drain()
            if out is not None:
                emitted += next(iter(out.values())).shape[0]
                yield out

        for members, streaming_mlpg in mlpg_groups:
            emit(streaming_mlpg.flush(), members)
        out = drain()
        if out is not None:
            emitted += next(iter(out.values())).shape[0]
            yield out
        if emitted != n_frames:
            raise RuntimeError(f'stream emitted {emitted} of {n_frames} frames')


class DynamicBatcher(object):
    """Coalesces concurrent :meth:`InferenceEngine.predict_items` calls into
    shared batches (``serve.py:752-928``).

    Callers block in :meth:`predict_items` while a worker thread gathers
    requests for up to ``max_wait_ms`` (or until ``max_batch`` utterances are
    pending), renames the items to internal ids, runs one engine call for the
    group and hands each caller back its own results under its own names.
    The group is padded to the next power of two (capped at ``max_batch``)
    by repeating its first item, so that the batch shapes and the dispatch
    counts are the JAX package's (which bounds its compiled programs so).
    A group that fails runs again request by request, so that one bad
    request fails only its own caller.

    Parameters
    ----------
    engine : InferenceEngine
    max_wait_ms : float
        How long a forming group waits for company once at least two
        requests are pending. A lone request never waits; 0 still coalesces
        what is queued already.
    max_batch : int, optional
        Utterances per group (default: the engine's ``batch_size``).
    lock : threading.Lock, optional
        The device lock, shared with the server's other paths; held around
        each engine call.
    max_queue : int, optional
        When more utterances than this are pending, :meth:`predict_items`
        raises :class:`Overloaded` (default ``32 * max_batch``). An empty
        queue admits a request of any size.

    Attributes
    ----------
    batches_run, requests_coalesced : int
        Engine calls made, and the requests they served.
    """

    def __init__(self, engine, max_wait_ms=5.0, max_batch=None, lock=None, max_queue=None):
        self.engine = engine
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_batch = int(max_batch or engine.batch_size)
        if self.max_batch < 1:
            raise ValueError('max_batch must be >= 1')
        self.max_queue = int(max_queue or 32 * self.max_batch)
        self.lock = lock if lock is not None else threading.Lock()
        self.batches_run = 0
        self.requests_coalesced = 0
        self._cv = threading.Condition()
        self._pending = []
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name='morgana-dynamic-batcher')
        self._worker.start()

    def predict_items(self, items):
        """The contract and results of ``engine.predict_items(items)``; blocks
        until this request's group has run. Names may repeat across
        requests, not within one."""
        if not items:
            return {}
        _check_unique([str(item.get('name', i)) for i, item in enumerate(items)])
        req = {'items': list(items), 'event': threading.Event(), 'results': None,
               'error': None}
        with self._cv:
            if self._closed:
                raise RuntimeError('DynamicBatcher is closed')
            queued = sum(len(r['items']) for r in self._pending)
            if queued and queued + len(req['items']) > self.max_queue:
                raise Overloaded(f'{queued} utterances already pending '
                                 f'(max_queue={self.max_queue}); retry later')
            self._pending.append(req)
            self._cv.notify()
        req['event'].wait()
        if req['error'] is not None:
            raise req['error']
        return req['results']

    def close(self):
        """Stops the worker after it has served the requests queued."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=30)

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:
                    return   # closed and drained
                # A lone request goes at once; the window opens only when two
                # or more are pending.
                if self.max_wait > 0 and not self._closed and len(self._pending) > 1:
                    deadline = time.monotonic() + self.max_wait
                    while sum(len(r['items']) for r in self._pending) < self.max_batch:
                        left = deadline - time.monotonic()
                        if left <= 0 or self._closed:
                            break
                        self._cv.wait(timeout=left)
                group, total = [], 0
                while self._pending:
                    n = len(self._pending[0]['items'])
                    if group and total + n > self.max_batch:
                        break
                    group.append(self._pending.pop(0))
                    total += n
            self._execute(group)

    @staticmethod
    def _padded_count(n, cap):
        """The next power of two >= n, capped at ``max(n, cap)``."""
        size = 1
        while size < n:
            size *= 2
        return min(size, max(n, cap))

    def _execute(self, group):
        renamed, owners = [], []
        for gi, req in enumerate(group):
            for ii, item in enumerate(req['items']):
                internal = dict(item, name=f'__dyn{gi}.{ii}')
                renamed.append(internal)
                owners.append((req, str(item.get('name', ii)), internal['name']))
        for p in range(self._padded_count(len(renamed), self.max_batch) - len(renamed)):
            renamed.append(dict(renamed[0], name=f'__dynpad{p}'))
        try:
            with self.lock:
                results = self.engine.predict_items(renamed)
            self.batches_run += 1
            self.requests_coalesced += len(group)
            split = {}
            for req, public, internal in owners:
                split.setdefault(id(req), {})[public] = results[internal]
            for req in group:
                req['results'] = split.get(id(req), {})
                req['event'].set()
        except Exception:   # noqa: BLE001 - each request runs again alone
            for req in group:
                try:
                    with self.lock:
                        req['results'] = self.engine.predict_items(req['items'])
                    self.batches_run += 1
                    self.requests_coalesced += 1
                except Exception as exc:   # noqa: BLE001 - delivered to the caller
                    req['error'] = exc
                req['event'].set()


class _Unported(argparse.Action):
    """A JAX flag the port lacks: an argparse error that says so, naming
    where ROADMAP.md places it (``const``, when given)."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f'{option_string} is not ported yet ({self.const or "ROADMAP.md"})')


def main(argv=None):
    """The serving command line (``serve.py:931-1086``): builds an
    :class:`InferenceEngine` (or, with ``--fleet``, one per voice) on
    ``--device`` (``cuda`` by default, an error without a GPU; ``cpu`` when
    asked). With ``--http_port`` it serves them over HTTP
    (:func:`morgana_tpu_torch.http_serve.serve_forever`, with
    ``--dynamic_batch_ms`` batching and ``--watch_checkpoints`` hot reload);
    otherwise it runs :meth:`InferenceEngine.generate` over ``--data_dir``
    and prints the stats as one JSON line. ``--compilation_cache_dir`` is
    where the kernels are built and found (:func:`morgana_tpu_torch._build.set_build_dir`).
    ``--compute_dtype bfloat16`` serves in bf16; the first engine of a fleet
    sets it for the process (``serve.py:1047``). ``--num_data_threads`` reads
    each batch's items on that many threads (``serve.py:948``).
    ``--data_parallel`` is not ported: it is an argparse error."""
    parser = argparse.ArgumentParser(
        description='Serve a trained checkpoint with the PyTorch/CUDA port of morgana_tpu: '
                    'generate wavs, or answer HTTP requests.')
    parser.add_argument('--model', default=None,
                        help="Model class: 'pkg.module:Class' or 'file.py:Class' (required "
                             'unless --fleet is given).')
    parser.add_argument('--checkpoint_path', default=None,
                        help='epoch_{N}.npz written by either package, or a quantized one.')
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
    parser.add_argument('--quantize', default=None, choices=['int8', 'int4'],
                        help='Serve weight-only quantized parameters: int8 (per channel) or '
                             'int4 (packed, group-wise scales). Quantized checkpoints (python -m '
                             'morgana_tpu_torch.quantize) are detected without this flag.')
    parser.add_argument('--stream_configs', default='64,32,16',
                        help='Semicolon-separated chunk_frames,context,lookahead triples that '
                             'the HTTP /stream endpoint serves.')
    parser.add_argument('--http_port', type=int, default=None,
                        help='Serve over HTTP on this port instead of generating '
                             '(GET /healthz, GET /stats, POST /predict, POST /stream).')
    parser.add_argument('--fleet', default=None,
                        help='Several voices: a JSON file mapping each name to an engine spec '
                             '({"model", "checkpoint_path", optional "model_kwargs", '
                             '"data_root", "normalisation_dir", "batch_size", "quantize", '
                             '"analysis_kwargs"}); unset fields take this command\'s flags. '
                             'Needs --http_port; a request picks its voice with a top-level '
                             '"model" key.')
    parser.add_argument('--http_host', default='127.0.0.1')
    parser.add_argument('--watch_checkpoints', type=float, default=0.0,
                        help='Poll every N seconds for a higher-epoch checkpoint beside each '
                             'served one and reload it (HTTP only).')
    parser.add_argument('--dynamic_batch_ms', type=float, default=5.0,
                        help='Coalesce concurrent /predict requests into shared batches, each '
                             'waiting at most this long for company once two are pending (0 '
                             'serves each request alone). A lone request never waits.')
    parser.add_argument('--compilation_cache_dir', default=None,
                        help='Build and find the CUDA kernels (and the vocoder library) in this '
                             'directory: a new process that finds them there runs no compiler.')
    parser.add_argument('--compute_dtype', default=None, type=precision.compute_dtype_arg,
                        help="'bfloat16': serve with bf16 products and f32 sums ('float32', the "
                             'default, leaves the products in f32).')
    parser.add_argument('--num_data_threads', type=int, default=0,
                        help='Threads that read each batch\'s utterances (0 reads them inline).')
    parser.add_argument('--data_parallel', nargs=0, action=_Unported, help='Not ported yet.')
    args = parser.parse_args(argv)
    if args.compilation_cache_dir:
        _build.set_build_dir(args.compilation_cache_dir)

    if args.fleet is None and (args.model is None or args.checkpoint_path is None):
        parser.error('--model and --checkpoint_path are required (or pass --fleet)')
    if args.fleet is not None and args.http_port is None:
        parser.error('--fleet serves over HTTP; add --http_port')
    if args.id_list is None and args.http_port is None:
        base = os.path.basename(os.path.normpath(args.data_dir))
        candidate = os.path.join(args.data_dir, f'{base}_file_id_list.scp')
        if os.path.exists(os.path.join(args.data_root, candidate)):
            args.id_list = candidate
        else:
            parser.error(f'--id_list is required (no conventional id list at '
                         f'{os.path.join(args.data_root, candidate)})')
    stream_configs = [tuple(int(v) for v in cfg.split(','))
                      for cfg in args.stream_configs.split(';') if cfg]

    def build_engine(spec, first=True):
        model_kwargs = spec.get('model_kwargs')
        analysis_kwargs = spec.get('analysis_kwargs')
        return InferenceEngine(
            load_model_class(spec.get('model', args.model)),
            spec.get('checkpoint_path', args.checkpoint_path),
            data_root=spec.get('data_root', args.data_root),
            normalisation_dir=spec.get('normalisation_dir', args.normalisation_dir),
            model_kwargs=ast.literal_eval(args.model_kwargs) if model_kwargs is None
            else model_kwargs,
            device=args.device, batch_size=int(spec.get('batch_size', args.batch_size)),
            analysis_kwargs=ast.literal_eval(args.analysis_kwargs) if analysis_kwargs is None
            else analysis_kwargs,
            stream_configs=stream_configs, quantize=spec.get('quantize', args.quantize),
            num_data_threads=args.num_data_threads,
            # The compute dtype is the process's: the first engine sets it.
            compute_dtype=args.compute_dtype if first else None)

    if args.fleet is not None:
        with open(args.fleet) as f:
            fleet = json.load(f)
        if not isinstance(fleet, dict) or not fleet:
            parser.error(f'--fleet {args.fleet} must be a non-empty JSON object of name -> '
                         'engine spec')
        for name, spec in fleet.items():
            if not isinstance(spec, dict):
                parser.error(f'--fleet entry {name!r} must be a JSON object '
                             f'(got {type(spec).__name__})')
            if 'checkpoint_path' not in spec:
                parser.error(f"--fleet entry {name!r} needs 'checkpoint_path'")
            if 'model' not in spec and args.model is None:
                parser.error(f"--fleet entry {name!r} needs 'model' (or pass a shared --model)")
        engine = {name: build_engine(spec, first=i == 0)
                  for i, (name, spec) in enumerate(fleet.items())}
    else:
        engine = build_engine({})

    if args.http_port is not None:
        from morgana_tpu_torch.http_serve import serve_forever
        serve_forever(engine, host=args.http_host, port=args.http_port,
                      dynamic_batch_ms=args.dynamic_batch_ms,
                      watch_checkpoints=args.watch_checkpoints)
        return
    stats = engine.generate(args.out_dir, data_dir=args.data_dir, id_list=args.id_list)
    print(json.dumps(stats))


if __name__ == '__main__':
    main()
