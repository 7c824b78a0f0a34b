"""Two-stage TTS from linguistic labels: durations, then acoustic features,
then waveforms (counterpart of ``morgana_tpu/pipeline.py``).

The reference's generation reads ground-truth durations and frame counts
from disk. :class:`TTSPipeline` chains two
:class:`~morgana_tpu_torch.serve.InferenceEngine` instances instead:

    dur_engine = InferenceEngine(DurationModel, 'dur/epoch_20.npz', ...)
    ac_engine = InferenceEngine(LSTMAcousticModel, 'ac/epoch_50.npz', ...)
    pipeline = TTSPipeline(dur_engine, ac_engine)
    results = pipeline.synthesize_ids(['utt_001'], data_dir='test', out_dir='tts_out')

* the predicted float durations are rounded to integer frames, at least
  ``min_frames_per_phone`` each (:func:`durations_to_int`);
* the frame-level ``counters`` input is rebuilt from the predicted
  durations by the data-prep definition (``data/prepare._frame_counters``);
* each engine is fed only its model's true inputs
  (:attr:`TTSPipeline.DURATION_INPUTS`, :attr:`TTSPipeline.ACOUSTIC_INPUTS`)
  through ``predict_items(..., sources=...)``;
* when the acoustic model emits lf0, vuv, mcep and bap, waveforms are
  synthesised as ``models/rnn_spss.py``'s analysis hook does: on the host,
  one utterance at a time, or with ``device_vocoder=True`` as one
  ``vocoder.torch_world.synthesize_batch`` call on the acoustic engine's
  device for every result.

On the GPU the duration stage's GRU is one launch of K3 a batch, an LSTM
acoustic model 8 of K1 a batch, the Transformer one of K5 a block.

From the shell (``--device cpu`` runs on the CPU; the GPU is the default)::

    python -m morgana_tpu_torch.pipeline \\
        --duration_model morgana_tpu_torch.models.duration_model:DurationModel \\
        --duration_checkpoint dur/checkpoints/epoch_20.npz \\
        --acoustic_model morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel \\
        --acoustic_checkpoint ac/checkpoints/epoch_50.npz \\
        --data_root data --data_dir test --out_dir tts_out [--device_vocoder]
"""
import argparse
import ast
import json
import os
import time

import numpy as np
import torch

from morgana_tpu_torch import vocoder
from morgana_tpu_torch.data import bucket_size, file_io
from morgana_tpu_torch.data.prepare import _frame_counters
from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.serve import InferenceEngine, _Unported, load_model_class
from morgana_tpu_torch.vocoder import torch_world

__all__ = ['TTSPipeline', 'durations_to_int', 'main']

WORLD_STREAMS = ('lf0', 'vuv', 'mcep', 'bap')


def durations_to_int(pred_dur, n_phones, min_frames_per_phone=1, max_total_frames=None):
    """Predicted float durations (P,) or (P, 1) -> ``(n_phones,)`` int64
    frame counts (``pipeline.py:54``): the padded tail dropped, rounded
    (``np.rint``) and floored at ``min_frames_per_phone``.
    ``max_total_frames`` rescales an over-long utterance and then trims the
    longest phones first until the cap holds exactly (unless ``n_phones *
    min_frames_per_phone`` already exceeds it: the floor wins). Non-finite
    durations raise."""
    dur = np.asarray(pred_dur, np.float64).reshape(-1)[:int(n_phones)]
    if not np.isfinite(dur).all():
        raise ValueError(f'{int(np.sum(~np.isfinite(dur)))} non-finite predicted duration(s); '
                         'the duration model appears to have diverged')
    if max_total_frames and dur.sum() > max_total_frames:
        dur = dur * (max_total_frames / max(dur.sum(), 1e-9))
    dur = np.maximum(np.rint(dur), min_frames_per_phone).astype(np.int64)
    if max_total_frames:
        excess = int(dur.sum()) - int(max_total_frames)
        while excess > 0 and (dur > min_frames_per_phone).any():
            for i in np.argsort(-dur):          # longest first, a frame a pass
                if excess == 0:
                    break
                if dur[i] > min_frames_per_phone:
                    dur[i] -= 1
                    excess -= 1
    return dur


class TTSPipeline(object):
    """A duration engine chained into an acoustic engine and the vocoder
    (``pipeline.py:93``).

    Parameters
    ----------
    duration_engine : InferenceEngine
        Over a model predicting ``'dur'`` from phone-level ``'lab'`` and
        ``'n_phones'`` (``models/duration_model.DurationModel``).
    acoustic_engine : InferenceEngine
        Over a model reading ``'lab'``, ``'dur'``, ``'counters'`` and
        ``'n_frames'`` (``models/rnn_spss``, ``models/transformer_spss``).
    min_frames_per_phone : int
        Floor of the rounded durations.
    max_total_frames : int, optional
        Cap on an utterance's predicted length.
    sample_rate : int
    counter_fn : callable, optional
        ``fn(n_frames, dur) -> (n_frames, D)``; the data-prep definition by
        default.
    device_vocoder : bool
        Synthesise every wav in one ``torch_world.synthesize_batch`` call on
        the acoustic engine's device, its noise from a generator on that
        device seeded 0 (the host path seeds numpy per utterance).
    """

    DURATION_INPUTS = ('n_phones', 'lab')
    ACOUSTIC_INPUTS = ('n_frames', 'dur', 'lab', 'counters')

    def __init__(self, duration_engine, acoustic_engine, min_frames_per_phone=1,
                 max_total_frames=None, sample_rate=16000, counter_fn=None,
                 device_vocoder=False):
        self.duration_engine = duration_engine
        self.acoustic_engine = acoustic_engine
        self.min_frames_per_phone = int(min_frames_per_phone)
        self.max_total_frames = max_total_frames
        self.sample_rate = int(sample_rate)
        self.device_vocoder = bool(device_vocoder)
        self.counter_fn = _frame_counters if counter_fn is None else counter_fn

    def _stage_sources(self, engine, names):
        sources = engine.model.test_data_sources()
        missing = [n for n in names if n not in sources]
        if missing:
            raise ValueError(f'{type(engine.model).__name__} has no data source(s) {missing}; '
                             f'pipeline stages need {names}')
        return {name: sources[name] for name in names}

    def predict_durations(self, items):
        """``items``: dicts with ``'name'`` and phone-level ``'lab'``. Returns
        ``{name: (P,) int64 frame counts}``."""
        sources = self._stage_sources(self.duration_engine, self.DURATION_INPUTS)
        built = []
        for i, item in enumerate(items):
            lab = np.asarray(item['lab'], np.float32)
            built.append({'name': str(item.get('name', i)), 'lab': lab,
                          'n_phones': np.asarray([[float(lab.shape[0])]], np.float32)})
        outputs = self.duration_engine.predict_items(built, sources=sources)
        durs = {}
        for item in built:
            out = outputs[item['name']]
            if 'dur' not in out:
                raise ValueError(f'{type(self.duration_engine.model).__name__}.predict must '
                                 "return a 'dur' output to drive the pipeline")
            durs[item['name']] = durations_to_int(
                out['dur'], item['lab'].shape[0], self.min_frames_per_phone,
                self.max_total_frames)
        return durs

    def _acoustic_item(self, name, lab, dur):
        """The acoustic stage's inputs from integer durations."""
        valid = dur[dur > 0]
        n_frames = int(valid.sum())
        return {'name': name, 'lab': np.asarray(lab, np.float32),
                'dur': dur.astype(np.float32)[:, None],
                'counters': self.counter_fn(n_frames, valid),
                'n_frames': np.asarray([[float(n_frames)]], np.float32)}

    def synthesize_items(self, items, out_dir=None):
        """The whole pipeline over in-memory items (``'name'`` + ``'lab'``).

        Returns ``{name: outputs}``: the integer ``'dur'``, ``'n_frames'``,
        every acoustic output (unpadded) and, when the model emits lf0, vuv,
        mcep and bap, a float ``'wav'``. With ``out_dir`` the wavs go to
        ``{out_dir}/synth/{name}.wav`` and every feature, durations
        included, to ``{out_dir}/feats/{key}/{name}.npy``."""
        durs = self.predict_durations(items)
        built = [self._acoustic_item(str(item.get('name', i)), item['lab'],
                                     durs[str(item.get('name', i))])
                 for i, item in enumerate(items)]
        acoustic = self.acoustic_engine.predict_items(
            built, sources=self._stage_sources(self.acoustic_engine, self.ACOUSTIC_INPUTS))

        results = {}
        for item in built:
            name = item['name']
            out = dict(acoustic[name])
            out['dur'] = durs[name]
            out['n_frames'] = int(item['n_frames'].ravel()[0])
            if not self.device_vocoder:
                wav = self._synthesize_wav(out)
                if wav is not None:
                    out['wav'] = wav
            results[name] = out
        if self.device_vocoder:
            self._synthesize_wavs_device(results)
        if out_dir:
            for name, out in results.items():
                self._dump_outputs(name, out, out_dir)
        return results

    def _dump_outputs(self, name, out, out_dir):
        for key, value in out.items():
            if key == 'wav':
                continue
            arr = np.asarray(value)
            if arr.ndim >= 1 and arr.dtype.kind in 'fiub':
                file_io.save_bin(arr, os.path.join(out_dir, 'feats', key, f'{name}.npy'))
        if 'wav' in out:
            file_io.save_wav(out['wav'], os.path.join(out_dir, 'synth', f'{name}.wav'),
                             sample_rate=self.sample_rate)

    def stream_audio(self, item, chunk_frames=64, context=32, lookahead=16, frame_period=5.0):
        """Streaming TTS from labels (``pipeline.py:242``): predicts the
        durations, then streams the acoustic model chunk by chunk to audio
        (:meth:`InferenceEngine.stream_item_audio`). Returns ``(dur,
        generator of (feature_chunk, wav_chunk))``, so that the caller knows
        the frame clock before the first chunk."""
        name = str(item.get('name', 0))
        dur = self.predict_durations([item])[name]
        gen = self.acoustic_engine.stream_item_audio(
            self._acoustic_item(name, item['lab'], dur), chunk_frames=chunk_frames,
            context=context, lookahead=lookahead, sample_rate=self.sample_rate,
            frame_period=frame_period,
            sources=self._stage_sources(self.acoustic_engine, self.ACOUSTIC_INPUTS))
        return dur, gen

    def synthesize_ids(self, file_ids, data_dir='test', out_dir=None):
        """The whole pipeline for utterances on disk: each id's phone-level
        labels read by the duration model's ``'lab'`` source."""
        lab_source = self._stage_sources(self.duration_engine, ('lab',))['lab']
        root_dir = os.path.join(self.duration_engine.data_root, data_dir)
        items = [{'name': utt, 'lab': lab_source.load_file(utt, root_dir)} for utt in file_ids]
        return self.synthesize_items(items, out_dir=out_dir)

    def _synthesize_wavs_device(self, results):
        """Adds ``'wav'`` to every result with lf0, vuv, mcep and bap by one
        ``torch_world.synthesize_batch`` call on the acoustic engine's device
        (``pipeline.py:284-329``): f0 smoothed on the host (as the host
        recipe does), streams of unequal length trimmed to the shortest,
        zero-padded to ``bucket_size`` of the longest."""
        names = [n for n, out in results.items() if all(k in out for k in WORLD_STREAMS)]
        if not names:
            return
        f0s, vuvs, lens = [], [], []
        for name in names:
            out = results[name]
            lf0 = np.asarray(out['lf0'], np.float64).reshape(-1)
            f0s.append(vocoder.smooth_f0(np.exp(lf0)))
            vuvs.append((np.asarray(out['vuv']).reshape(-1) > 0.5).astype(np.float32))
            lens.append(min(lf0.shape[0], vuvs[-1].shape[0], np.asarray(out['mcep']).shape[0],
                            np.asarray(out['bap']).shape[0]))
        num_frames = bucket_size(max(lens))
        mcep_dim = np.asarray(results[names[0]]['mcep']).shape[-1]
        bap_dim = np.asarray(results[names[0]]['bap']).shape[-1]
        f0_b = np.zeros((len(names), num_frames), np.float32)
        vuv_b = np.zeros((len(names), num_frames), np.float32)
        mcep_b = np.zeros((len(names), num_frames, mcep_dim), np.float32)
        bap_b = np.zeros((len(names), num_frames, bap_dim), np.float32)
        for i, name in enumerate(names):
            n = lens[i]
            f0_b[i, :n] = f0s[i][:n]
            vuv_b[i, :n] = vuvs[i][:n]
            mcep_b[i, :n] = np.asarray(results[name]['mcep'], np.float32)[:n]
            bap_b[i, :n] = np.asarray(results[name]['bap'], np.float32)[:n]
        with torch.inference_mode():
            waves, wave_lens = torch_world.synthesize_batch(
                f0_b, vuv_b, mcep_b, bap_b, np.asarray(lens), self.sample_rate,
                device=self.acoustic_engine.device)
            waves, wave_lens = waves.cpu().numpy(), wave_lens.cpu().numpy()
        for i, name in enumerate(names):
            results[name]['wav'] = waves[i, :int(wave_lens[i])]

    def _synthesize_wav(self, outputs):
        """Host WORLD synthesis of one result with lf0, vuv, mcep and bap, as
        ``models/rnn_spss.py``'s analysis hook does; else None."""
        if not all(k in outputs for k in WORLD_STREAMS):
            return None
        lf0 = np.asarray(outputs['lf0'], np.float64).reshape(-1)
        vuv = np.asarray(outputs['vuv']).reshape(-1) > 0.5
        f0 = vocoder.smooth_f0(np.exp(lf0))
        return vocoder.synthesize_world_feats(
            f0, vuv, np.asarray(outputs['mcep'], np.float64),
            np.asarray(outputs['bap'], np.float64), self.sample_rate)


def main(argv=None):
    """Labels to wavs from the command line (``pipeline.py:355``): builds
    both engines on ``--device`` (``cuda`` by default, an error without a
    GPU; ``cpu`` when asked), runs :meth:`TTSPipeline.synthesize_ids` over
    ``--data_dir`` into ``--out_dir`` and prints its stats as one JSON
    line: ``utterances``, ``frames``, ``wavs``, ``seconds``,
    ``frames_per_sec``, ``out_dir`` and, with ``--evaluate_against``, the
    scores of ``evaluate.evaluate_dirs``. ``--quantize int8|int4`` serves
    both stages quantized, ``--compute_dtype bfloat16`` both in bf16 (the
    duration engine sets it for the process, ``pipeline.py:404``).
    ``--data_parallel`` is an argparse error."""
    parser = argparse.ArgumentParser(
        description='Two-stage TTS generation with the PyTorch/CUDA port of morgana_tpu: '
                    'duration model -> acoustic model -> WORLD vocoder, from phone-level '
                    'label files.')
    parser.add_argument('--duration_model', required=True,
                        help="'pkg.module:Class' or 'file.py:Class'.")
    parser.add_argument('--duration_checkpoint', required=True)
    parser.add_argument('--acoustic_model', required=True)
    parser.add_argument('--acoustic_checkpoint', required=True)
    parser.add_argument('--data_root', default='.')
    parser.add_argument('--normalisation_dir', default='train')
    parser.add_argument('--data_dir', default='test')
    parser.add_argument('--id_list', default=None,
                        help='Id-list file (relative to --data_root). Defaults to the '
                             'conventional {data_dir}/{data_dir}_file_id_list.scp.')
    parser.add_argument('--out_dir', default='tts_generated')
    parser.add_argument('--sample_rate', type=int, default=16000)
    parser.add_argument('--min_frames_per_phone', type=int, default=1)
    parser.add_argument('--max_total_frames', type=int, default=None)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--device', default=None,
                        help="'cuda' (the default; an error without a GPU), 'cuda:N' or 'cpu'.")
    parser.add_argument('--device_vocoder', action='store_true', default=False,
                        help='Synthesise all waveforms in one batched call on the acoustic '
                             "engine's device instead of the per-utterance host vocoder.")
    parser.add_argument('--duration_model_kwargs', default='{}')
    parser.add_argument('--acoustic_model_kwargs', default='{}')
    parser.add_argument('--evaluate_against', default=None,
                        help='Reference feature directory (e.g. the data split itself): score '
                             'the dumped features with morgana_tpu_torch.evaluate and add the '
                             'scores to the stats line.')
    parser.add_argument('--quantize', default=None, choices=['int8', 'int4'],
                        help='Serve both stages with weight-only quantized parameters (int8, '
                             'or packed group-wise int4).')
    parser.add_argument('--compute_dtype', default=None, type=precision.compute_dtype_arg,
                        help="'bfloat16': serve both stages with bf16 products and f32 sums.")
    parser.add_argument('--data_parallel', nargs=0, action=_Unported, help='Not ported yet.')
    args = parser.parse_args(argv)

    if args.id_list is None:
        base = os.path.basename(os.path.normpath(args.data_dir))
        args.id_list = os.path.join(args.data_dir, f'{base}_file_id_list.scp')
    ids = file_io.get_file_ids(os.path.join(args.data_root, args.id_list))

    common = dict(data_root=args.data_root, normalisation_dir=args.normalisation_dir,
                  device=args.device, batch_size=args.batch_size, quantize=args.quantize)
    duration_engine = InferenceEngine(
        load_model_class(args.duration_model), args.duration_checkpoint,
        model_kwargs=ast.literal_eval(args.duration_model_kwargs),
        compute_dtype=args.compute_dtype, **common)
    acoustic_engine = InferenceEngine(
        load_model_class(args.acoustic_model), args.acoustic_checkpoint,
        model_kwargs=ast.literal_eval(args.acoustic_model_kwargs), **common)
    pipeline = TTSPipeline(duration_engine, acoustic_engine,
                           min_frames_per_phone=args.min_frames_per_phone,
                           max_total_frames=args.max_total_frames, sample_rate=args.sample_rate,
                           device_vocoder=args.device_vocoder)
    start = time.perf_counter()
    results = pipeline.synthesize_ids(ids, data_dir=args.data_dir, out_dir=args.out_dir)
    elapsed = time.perf_counter() - start
    frames = sum(r['n_frames'] for r in results.values())
    stats = {'utterances': len(results), 'frames': int(frames),
             'wavs': sum(1 for r in results.values() if 'wav' in r),
             'seconds': round(elapsed, 3),
             'frames_per_sec': round(frames / elapsed, 1) if elapsed else 0.0,
             'out_dir': args.out_dir}
    if args.evaluate_against:
        from morgana_tpu_torch.evaluate import evaluate_dirs
        try:
            stats['evaluation'] = evaluate_dirs(args.evaluate_against,
                                                os.path.join(args.out_dir, 'feats'), ids,
                                                device=acoustic_engine.device)
        except Exception as exc:  # noqa: BLE001 - the generated files are on disk
            stats['evaluation_error'] = f'{type(exc).__name__}: {exc}'
    print(json.dumps(stats))


if __name__ == '__main__':
    main()
