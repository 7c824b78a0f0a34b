"""Objective evaluation of generated features against a reference directory
(counterpart of ``morgana_tpu/evaluate.py``).

Both directories hold the per-utterance layout ``{dir}/{feat}/{utt}.npy``
(data splits, ``viz.io.save_batched_seqs`` dumps, the pipeline's
``feats/``). The metrics are the training logs' (:mod:`morgana_tpu_torch.metrics`):

* ``lf0``  -> LF0 RMSE in Hz over the frames voiced in both, by each side's
  ``vuv`` where present;
* ``mcep`` -> mel-cepstral distortion without C0;
* ``bap``  -> band-aperiodicity distortion in dB;
* ``vuv``  -> voicing agreement (%);
* another feature named in ``feats`` -> plain RMSE.

An utterance whose lengths differ (the rule when durations were predicted)
is scored over its first ``min(len_ref, len_gen)`` frames, and the mean
length ratio is reported beside the scores. The files are read on the host
and the metric sums run on ``device``: the GPU unless the caller asks for the
CPU, as every entry point of the port. From the shell::

    python -m morgana_tpu_torch.evaluate --ref_dir data/test --gen_dir tts_out/feats \\
        [--id_list data/test/test_file_id_list.scp] [--feats lf0,mcep] [--device cpu]

prints one JSON line of metric -> value.
"""
import argparse
import json
import os

import numpy as np
import torch

from morgana_tpu_torch import metrics as metrics_mod
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.device import resolve_device

__all__ = ['evaluate_dirs', 'main']

_KNOWN = ('lf0', 'mcep', 'bap', 'vuv')


def _load(dirpath, feat, utt):
    path = os.path.join(dirpath, feat, f'{utt}.npy')
    if not os.path.exists(path):
        return None
    arr = np.asarray(np.load(path), np.float32)
    return arr[:, None] if arr.ndim == 1 else arr


def _common_feats(ref_dir, gen_dir):
    def subdirs(d):
        return {name for name in os.listdir(d) if os.path.isdir(os.path.join(d, name))}
    return sorted(subdirs(ref_dir) & subdirs(gen_dir))


def _metric(feat):
    """(result name, metric) for one feature."""
    if feat == 'lf0':
        return 'LF0_RMSE_Hz', metrics_mod.LF0Distortion()
    if feat == 'mcep':
        return 'MCEP_distortion', metrics_mod.MelCepDistortion()
    if feat == 'bap':
        return 'BAP_distortion_dB', metrics_mod.Distortion()
    if feat == 'vuv':
        return 'VUV_agreement_pct', metrics_mod.Mean()
    return f'{feat}_RMSE', metrics_mod.RMSE()


def evaluate_dirs(ref_dir, gen_dir, file_ids, feats=None, device=None):
    """Scores ``gen_dir`` against ``ref_dir`` over ``file_ids``
    (``evaluate.py:65``).

    ``feats`` names the features to score (default: each of lf0, mcep, bap
    and vuv with a subdirectory in both). The metrics run on ``device``
    (``cuda`` by default, a ``DeviceError`` without a GPU; ``cpu`` when
    asked). Returns the scores, each with its count of utterances,
    ``utterances`` and ``mean_length_ratio`` (generated over reference
    frames). Raises if nothing could be compared."""
    device = resolve_device(device)

    def on_device(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    if feats is None:
        feats = [f for f in _common_feats(ref_dir, gen_dir) if f in _KNOWN]
    if not feats:
        raise ValueError(f'no common scoreable feature subdirectories between {ref_dir} and '
                         f'{gen_dir} (known: {list(_KNOWN)}; pass feats=... to score others '
                         'with plain RMSE)')
    accs = {feat: _metric(feat) for feat in feats}

    ratios = []
    compared = dict.fromkeys(feats, 0)
    for utt in file_ids:
        lens, pairs = [], {}
        for feat in feats:
            ref, gen = _load(ref_dir, feat, utt), _load(gen_dir, feat, utt)
            if ref is None or gen is None:
                continue
            pairs[feat] = (ref, gen)
            lens.append((gen.shape[0], ref.shape[0]))
        if not pairs:
            continue
        ref_frames = max(r for _, r in lens)
        if ref_frames:
            ratios.append(max(g for g, _ in lens) / ref_frames)

        ref_vuv, gen_vuv = _load(ref_dir, 'vuv', utt), _load(gen_dir, 'vuv', utt)
        for feat, (ref, gen) in pairs.items():
            n = min(ref.shape[0], gen.shape[0])
            if n == 0 or ref.shape[1:] != gen.shape[1:]:
                continue
            ref_b, gen_b = on_device(ref[None, :n]), on_device(gen[None, :n])
            metric = accs[feat][1]
            if feat == 'lf0':
                voiced = np.ones((1, n, 1), np.float32)
                if ref_vuv is not None:
                    voiced = voiced * (ref_vuv[None, :n] > 0.5)
                if gen_vuv is not None:
                    voiced = voiced * (gen_vuv[None, :n] > 0.5)
                metric.accumulate(ref_b, gen_b, on_device(voiced))
            elif feat == 'vuv':
                metric.accumulate(((ref_b > 0.5) == (gen_b > 0.5)).float())
            else:
                metric.accumulate(ref_b, gen_b)
            compared[feat] += 1

    results = {}
    for feat, (name, metric) in accs.items():
        if compared[feat]:
            value = float(metric.result())
            results[name] = round(value * 100.0 if feat == 'vuv' else value, 6)
            results[f'{name}_utterances'] = compared[feat]
    if not results:
        raise ValueError(f'no comparable utterances: checked {len(file_ids)} ids over features '
                         f'{feats} in {ref_dir} vs {gen_dir}')
    results['utterances'] = len(ratios)
    if ratios:
        results['mean_length_ratio'] = round(float(np.mean(ratios)), 4)
    return results


def main(argv=None):
    """The command line (``evaluate.py:167``)."""
    parser = argparse.ArgumentParser(
        description='Objective evaluation of generated features against a reference '
                    'directory (the metric definitions of the training logs).')
    parser.add_argument('--ref_dir', required=True,
                        help='Reference features: {ref_dir}/{feat}/{utt}.npy (e.g. a data '
                             'split directory).')
    parser.add_argument('--gen_dir', required=True,
                        help="Generated features in the same layout (e.g. a pipeline run's "
                             'feats/ directory).')
    parser.add_argument('--id_list', default=None,
                        help='Id-list file; defaults to every utterance of the first common '
                             'feature directory that holds .npy files.')
    parser.add_argument('--feats', default=None,
                        help='Comma-separated feature names (default: lf0, mcep, bap and vuv '
                             'where both directories have them).')
    parser.add_argument('--device', default=None,
                        help="'cuda' (the default; an error without a GPU), 'cuda:N' or 'cpu'.")
    args = parser.parse_args(argv)

    if args.id_list:
        ids = file_io.get_file_ids(args.id_list)
    else:
        # From a directory of .npy files: a split keeps 'dur' as .txt files.
        feats = _common_feats(args.ref_dir, args.gen_dir)
        ids = []
        for feat in [f for f in feats if f in _KNOWN] + feats:
            ids = sorted(os.path.splitext(f)[0]
                         for f in os.listdir(os.path.join(args.ref_dir, feat))
                         if f.endswith('.npy'))
            if ids:
                break
        if not ids:
            parser.error(f'no .npy utterances found in any common feature subdirectory of '
                         f'{args.ref_dir} and {args.gen_dir} (common: {feats})')
    feats = args.feats.split(',') if args.feats else None
    print(json.dumps(evaluate_dirs(args.ref_dir, args.gen_dir, ids, feats=feats,
                                   device=args.device)))


if __name__ == '__main__':
    main()
