"""Synthetic voice corpus in the on-disk layout the framework reads (the
port's own copy of ``morgana_tpu/data/synthetic.py``): per-utterance feature
files under ``{data_root}/{split}/{feat}/{utt}.{ext}``, id-list ``.scp``
files and normalisation parameter JSONs. The same signature and the same
order of random draws as the JAX package's, so the same seed writes the same
files."""
import os

import numpy as np

from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.data.normalisers import fit_minmax_params, fit_mvn_params
from morgana_tpu_torch.ops.deltas import compute_deltas

__all__ = ['generate_voice_data']


def _utt_features(rng, n_phones_range=(8, 24), dur_range=(3, 12),
                  lab_dim=600, counters_dim=9, mcep_dim=60, bap_dim=5, sp_bins=513,
                  voice_proj=None):
    n_phones = int(rng.integers(*n_phones_range))
    dur = rng.integers(dur_range[0], dur_range[1], size=(n_phones, 1)).astype(np.int64)
    n_frames = int(dur.sum())

    lab = rng.random((n_phones, lab_dim)).astype(np.float32)
    counters = rng.random((n_frames, counters_dim)).astype(np.float32)

    t = np.arange(n_frames)
    if voice_proj is not None:
        # Learnable targets: lf0/mcep/bap are a fixed per-voice projection of
        # the duration-upsampled, smoothed labels plus small noise.
        lab_frames = np.repeat(lab, dur[:, 0], axis=0)
        base = lab_frames @ voice_proj
        k = np.hanning(9)
        k /= k.sum()
        base = np.apply_along_axis(lambda c: np.convolve(c, k, mode='same'), 0, base)
        lf0 = (np.log(160.) + 0.3 * base[:, :1]
               + 0.01 * rng.standard_normal((n_frames, 1))).astype(np.float32)
        mcep = (0.3 * base[:, 1:1 + mcep_dim]
                + 0.01 * rng.standard_normal((n_frames, mcep_dim))).astype(np.float32)
        mcep[:, 0] += -2.0
        bap = (-2.0 + 0.3 * base[:, 1 + mcep_dim:]
               + 0.01 * rng.standard_normal((n_frames, bap_dim))).astype(np.float32)
    else:
        lf0 = (np.log(160.) + 0.25 * np.sin(2 * np.pi * t / max(40, n_frames // 3))
               + 0.05 * rng.standard_normal(n_frames)).astype(np.float32)[:, None]
        mcep = (0.1 * rng.standard_normal((n_frames, mcep_dim))).astype(np.float32)
        mcep[:, 0] += -2.0
        bap = (-2.0 + 0.3 * rng.standard_normal((n_frames, bap_dim))).astype(np.float32)

    vuv = (rng.random((n_frames, 1)) > 0.2).astype(np.float32)

    sp = np.abs(0.01 * rng.standard_normal((n_frames, sp_bins)) + 0.01).astype(np.float32)
    ap = np.clip(rng.random((n_frames, sp_bins)) * 0.5, 1e-4, 1.0).astype(np.float32)

    return {
        'n_frames': np.array([n_frames], np.float32),
        'n_phones': np.array([n_phones], np.float32),
        'dur': dur,
        'lab': lab,
        'counters': counters,
        'lf0': lf0,
        'vuv': vuv,
        'mcep': mcep,
        'bap': bap,
        'sp': sp,
        'ap': ap,
    }


def generate_voice_data(data_root, num_train=8, num_valid=4, num_test=2, seed=2468,
                        lab_dim=600, counters_dim=9, mcep_dim=60, bap_dim=5,
                        sp_bins=513, dur_range=(3, 12), n_phones_range=(8, 24),
                        speakers=None):
    r"""Writes a complete synthetic voice dataset under ``data_root``
    (``data/synthetic.py:76``).

    With ``speakers`` (a list of speaker names), utterances are assigned
    speakers round-robin, with a per-utterance ``speaker_id`` text file, a
    ``speakers.scp`` id list and per-speaker lf0 normalisation parameters.

    Returns a dict with the id lists per split.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(data_root, exist_ok=True)

    splits = {'train': num_train, 'valid': num_valid, 'test': num_test}
    id_lists = {}
    train_feats_for_norm = {}
    per_speaker_feats = {}

    voice_proj = (rng.standard_normal((lab_dim, 1 + mcep_dim + bap_dim))
                  / np.sqrt(lab_dim)).astype(np.float32)

    if speakers:
        if splits.get('train', 0) < len(speakers):
            raise ValueError(
                f'num_train={splits.get("train", 0)} < {len(speakers)} '
                f'speakers: every speaker in speakers.scp needs at least one '
                f'train utterance to fit its normalisation params')
        file_io.save_lines(speakers, os.path.join(data_root, 'speakers.scp'))

    for split, count in splits.items():
        split_dir = os.path.join(data_root, split)
        ids = [f'{split}_{i:04d}' for i in range(count)]
        id_lists[split] = ids
        file_io.save_lines(ids, os.path.join(split_dir, f'{split}_file_id_list.scp'))

        for utt_index, utt_id in enumerate(ids):
            feats = _utt_features(rng, n_phones_range=n_phones_range, dur_range=dur_range,
                                  lab_dim=lab_dim, counters_dim=counters_dim,
                                  mcep_dim=mcep_dim, bap_dim=bap_dim, sp_bins=sp_bins,
                                  voice_proj=voice_proj)

            if speakers:
                speaker_index = utt_index % len(speakers)
                speaker = speakers[speaker_index]
                feats['lf0'] = feats['lf0'] + 0.2 * speaker_index
                spk_dir = os.path.join(split_dir, 'speaker_id')
                os.makedirs(spk_dir, exist_ok=True)
                with open(os.path.join(spk_dir, f'{utt_id}.txt'), 'w') as f:
                    f.write(speaker)
                if split == 'train':
                    per_speaker_feats.setdefault(speaker, []).append(feats['lf0'])

            file_io.save_txt(feats['n_frames'].astype(np.int64),
                             os.path.join(split_dir, 'n_frames', f'{utt_id}.txt'))
            file_io.save_txt(feats['n_phones'].astype(np.int64),
                             os.path.join(split_dir, 'n_phones', f'{utt_id}.txt'))
            file_io.save_txt(feats['dur'], os.path.join(split_dir, 'dur', f'{utt_id}.txt'))

            for name in ('lab', 'counters', 'lf0', 'vuv', 'mcep', 'bap', 'sp', 'ap'):
                file_io.save_bin(feats[name], os.path.join(split_dir, name, f'{utt_id}.npy'))

            if split == 'train':
                for name in ('dur', 'lab', 'counters', 'lf0', 'mcep', 'bap'):
                    train_feats_for_norm.setdefault(name, []).append(feats[name])
                for name in ('lf0', 'mcep', 'bap'):
                    train_feats_for_norm.setdefault(name + '_deltas', []).append(
                        compute_deltas(feats[name]))

    # Normalisation parameters go into the train dir, the default
    # --normalisation_dir.
    norm_dir = os.path.join(data_root, 'train')
    for name in ('dur', 'lf0', 'mcep', 'bap', 'lf0_deltas', 'mcep_deltas', 'bap_deltas'):
        file_io.save_json(fit_mvn_params(train_feats_for_norm[name]),
                          os.path.join(norm_dir, f'{name}_mvn.json'))
    for name in ('lab', 'counters'):
        file_io.save_json(fit_minmax_params(train_feats_for_norm[name]),
                          os.path.join(norm_dir, f'{name}_minmax.json'))

    if speakers:
        for speaker, feats_list in per_speaker_feats.items():
            file_io.save_json(fit_mvn_params(feats_list),
                              os.path.join(norm_dir, speaker, 'lf0_mvn.json'))

    return id_lists
