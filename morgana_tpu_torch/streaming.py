"""Streaming MLPG (counterpart of ``morgana_tpu/streaming.py``).

Full MLPG (``viz/synthesis.MLPG``) solves one banded system over the whole
utterance, so it cannot run causally. The banded precision matrix's
inverse decays exponentially off the diagonal, so a solve over a window of
``context`` past and ``lookahead`` future frames around each chunk comes
within a tolerance of the full trajectory that shrinks exponentially in
``min(context, lookahead)``. Every window has the same padded length, and
a stream holds O(window) frames whatever the utterance's length.

The model-facing streaming contract (``stream_inputs`` / ``stream_step`` /
``stream_output_spec``) is on :class:`morgana_tpu_torch.base_models.BaseSPSS`;
the loop that drives it is :class:`morgana_tpu_torch.serve.StreamingSession`.
"""
import numpy as np

from morgana_tpu_torch.ops.deltas import DEFAULT_WINDOWS
from morgana_tpu_torch.viz.synthesis import MLPG

__all__ = ['StreamingMLPG']


class StreamingMLPG(object):
    """Incremental MLPG (``streaming.py:30-175``): push delta-feature means
    chunk by chunk, receive smoothed trajectory frames ``lookahead`` frames
    later.

    Parameters
    ----------
    variances : array (W*D,)
        Global variances of the delta streams (as in ``MLPG``).
    chunk_size : int
        Frames emitted per interior emission.
    context : int
        Past frames in each window solve.
    lookahead : int
        Future frames needed before a frame is emitted: frames ``[s,
        s + chunk)`` wait for means up to ``s + chunk + lookahead``.
    padding_size : int
        Edge burn-in of every window solve; at the utterance's true edges
        this is full ``MLPG(padding_size=...)``.
    windows : optional
        MLPG window set (default: static, delta, delta-delta).

    Every window is ``(B, context + chunk + lookahead, W*D)``, right-padded
    with its last frame; MLPG's ``seq_len`` masks the padding. The solves
    run on the host (the port's MLPG on CPU tensors).
    """

    def __init__(self, variances, chunk_size, context=32, lookahead=16, padding_size=0,
                 windows=None):
        if chunk_size < 1:
            raise ValueError('chunk_size must be >= 1')
        if context < 0 or lookahead < 0:
            raise ValueError('context and lookahead must be >= 0')
        self.variances = np.asarray(variances, np.float32)
        self.chunk_size = int(chunk_size)
        self.context = int(context)
        self.lookahead = int(lookahead)
        self.padding_size = int(padding_size)
        self.windows = windows
        self.window_frames = self.context + self.chunk_size + self.lookahead

        self._chunks = []        # retained mean chunks, each (B, c_i, W*D)
        self._base = 0           # absolute index of the first retained frame
        self._total = 0          # frames pushed
        self._emitted = 0        # frames emitted
        self._finished = False

    def push(self, means):
        """Feeds ``means`` (B, c, W*D); returns the frames now emittable,
        (B, n_new, D), ``n_new`` possibly 0 while the lookahead fills."""
        if self._finished:
            raise RuntimeError('push() after flush()')
        means = np.asarray(means)
        if means.ndim != 3:
            raise ValueError(f'means must be (batch, frames, W*D), got shape {means.shape}')
        if means.shape[1]:
            self._chunks.append(means)
            self._total += means.shape[1]

        emitted = []
        while self._total >= self._emitted + self.chunk_size + self.lookahead:
            emitted.append(self._solve_window(self._emitted, self._emitted + self.chunk_size))
            self._emitted += self.chunk_size
        self._trim()
        return self._concat(emitted, means.shape[0])

    def flush(self):
        """Emits every remaining frame; the stream is finished after it."""
        if self._finished:
            raise RuntimeError('flush() called twice')
        self._finished = True
        emitted = []
        while self._emitted < self._total:
            stop = min(self._emitted + self.chunk_size, self._total)
            emitted.append(self._solve_window(self._emitted, stop))
            self._emitted = stop
        batch = self._chunks[0].shape[0] if self._chunks else 1
        return self._concat(emitted, batch)

    @property
    def delay_frames(self):
        """Worst-case emission delay in frames (lookahead + chunk
        granularity)."""
        return self.lookahead + self.chunk_size - 1

    def _concat(self, parts, batch):
        if not parts:
            num_windows = len(self.windows if self.windows is not None else DEFAULT_WINDOWS)
            return np.zeros((batch, 0, self.variances.shape[-1] // num_windows), np.float32)
        return np.concatenate(parts, axis=1)

    def _retained(self):
        """The retained means as one array."""
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks, axis=1)]
        return self._chunks[0]

    def _trim(self):
        """Drops the frames no later window reads (before ``emitted -
        context``)."""
        keep_from = self._emitted - self.context
        if keep_from <= self._base or not self._chunks:
            return
        self._chunks = [self._retained()[:, keep_from - self._base:]]
        self._base = keep_from

    def _solve_window(self, start, stop):
        """Solves one window and returns its frames [start, stop)."""
        lo = max(0, start - self.context)
        hi = min(self._total, stop + self.lookahead)
        window = self._retained()[:, lo - self._base:hi - self._base]
        batch, n = window.shape[0], window.shape[1]
        if n < self.window_frames:
            pad = np.repeat(window[:, -1:], self.window_frames - n, axis=1)
            window = np.concatenate([window, pad], axis=1)
        traj = MLPG(np.ascontiguousarray(window, np.float32), self.variances,
                    windows=self.windows, padding_size=self.padding_size,
                    seq_len=np.full((batch,), n, np.int64))
        return traj[:, start - lo:stop - lo].astype(np.float32, copy=False)
