"""The data-prep definitions that generation shares with training corpora
(counterpart of ``morgana_tpu/data/prepare.py``): phone durations fitted to
an utterance's frame count, and the frame-level ``counters`` feature.

:func:`_frame_counters` is the train/serve definition of ``counters`` that
``pipeline.TTSPipeline`` rebuilds from predicted durations. The corpus
builder itself (``prepare_voice`` and its command line) is not ported yet
(ROADMAP.md).
"""
import numpy as np

__all__ = ['fit_durations']


def fit_durations(dur, n_frames, utt_id=''):
    """Clips or pads phone durations so that they sum exactly to
    ``n_frames`` (``data/prepare.py:27``): excess frames are trimmed from the
    last phones backwards, keeping every phone at one frame or more; a
    shortfall pads the final phone."""
    dur = np.asarray(dur, np.int64).copy()
    total = int(dur.sum())
    if total > n_frames:
        excess = total - n_frames
        for i in range(len(dur) - 1, -1, -1):
            take = min(excess, int(dur[i]) - 1)
            dur[i] -= take
            excess -= take
            if excess == 0:
                break
        if excess:
            raise ValueError(f'{utt_id}: label has more phones ({len(dur)}) '
                             f'than analysed frames ({n_frames})')
    elif total < n_frames:
        dur[-1] += n_frames - total
    return dur


def _frame_counters(n_frames, dur=None):
    """The 9 frame-position counter columns (``data/prepare.py:50``): global
    position forward, backward and as a fraction; position within the phone
    forward, backward and as a fraction; phone index forward, backward and
    as a fraction (zeros when the durations are unknown). Returns
    ``(n_frames, 9)`` float32."""
    t = np.arange(n_frames, dtype=np.float32)
    cols = [t, n_frames - 1 - t, t / max(n_frames - 1, 1)]
    if dur is not None:
        phone_idx = np.repeat(np.arange(len(dur)), dur)[:n_frames]
        start = np.repeat(np.cumsum(dur) - dur, dur)[:n_frames]
        within = t - start
        dur_per_frame = np.repeat(dur, dur)[:n_frames].astype(np.float32)
        cols += [within, dur_per_frame - 1 - within,
                 within / np.maximum(dur_per_frame - 1, 1),
                 phone_idx.astype(np.float32),
                 len(dur) - 1 - phone_idx.astype(np.float32),
                 phone_idx / max(len(dur) - 1, 1)]
    else:
        cols += [np.zeros(n_frames, np.float32)] * 6
    return np.stack(cols, axis=1).astype(np.float32)
