"""Run logging: console and file channels and a metric progress bar (the
port's copy of ``morgana_tpu/_logging.py``).

Every experiment gets a ``log/`` directory with timestamped ``.stdout``,
``.stderr`` and ``.tqdm`` files: normal records go to the console and the
``.stdout`` file, errors also to stderr and the ``.stderr`` file, and the
progress bar's per-batch descriptions only to the ``.tqdm`` file. Routing is
by the record level and an ``is_tqdm`` attribute (the log call's ``extra``),
by the spec table :data:`_CHANNELS`.
"""
import logging
import os
import sys
import time

__all__ = ['create_logger', 'ProgressBar', 'LOGGER_NAME']

LOGGER_NAME = 'morgana_tpu_torch'

_DETAIL_FMT = '{asctime} - {levelname:8s} - {module}.{funcName}:{lineno} - {message}'
_BARE_FMT = '{asctime} - {message}'


def _is_progress(record):
    """True for records tagged with ``extra={'is_tqdm': True}``."""
    return bool(getattr(record, 'is_tqdm', False))


class _Route(logging.Filter):
    """Admits the records a predicate admits."""

    def __init__(self, predicate):
        super().__init__()
        self._admit = predicate

    def filter(self, record):
        return self._admit(record)


def _progress_only(record):
    return _is_progress(record)


def _console_out(record):
    return not _is_progress(record) and record.levelno < logging.ERROR


def _everything_else(record):
    return not _is_progress(record)


def _errors_only(record):
    return not _is_progress(record) and record.levelno >= logging.ERROR


# (sink, format, predicate): a file suffix under log/, or the name of a sys
# stream, looked up when the logger is made (so that a later redirection, as
# pytest's capture, is honoured).
_CHANNELS = (
    ('.tqdm', _BARE_FMT, _progress_only),
    ('stdout', _DETAIL_FMT, _console_out),
    ('.stdout', _DETAIL_FMT, _everything_else),
    ('stderr', _DETAIL_FMT, _errors_only),
    ('.stderr', _DETAIL_FMT, _errors_only),
)


def create_logger(experiment_dir, process_index=0):
    """The experiment's logger, from :data:`_CHANNELS` (``_logging.py:76``).
    A repeated call replaces the handlers (and closes the old files); a
    process other than the first suffixes its files ``.pN``."""
    log_dir = os.path.join(experiment_dir, 'log')
    os.makedirs(log_dir, exist_ok=True)
    run_stamp = time.strftime('%y_%m_%d-%H_%M_%S')
    if process_index:
        run_stamp += f'.p{process_index}'

    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    while logger.handlers:
        handler = logger.handlers[-1]
        logger.removeHandler(handler)
        handler.close()

    for sink, fmt, predicate in _CHANNELS:
        if sink.startswith('.'):
            handler = logging.FileHandler(os.path.join(log_dir, run_stamp + sink))
        else:
            handler = logging.StreamHandler(getattr(sys, sink))
        handler.setFormatter(logging.Formatter(fmt, style='{'))
        handler.addFilter(_Route(predicate))
        logger.addHandler(handler)
    return logger


class ProgressBar:
    """Iterable batch counter with a live bar and metric text
    (``_logging.py:113``). Iterating yields ``0..num_batches-1``.
    :meth:`print` logs ``mode | epoch N: k = v | ...`` to the ``.tqdm``
    channel (and shows it on the bar); :meth:`maybe_print` builds the metric
    dict, and so reads device values, only every ``print_interval``-th call:
    between two prints the loop makes no host sync. The bar is drawn by
    ``tqdm`` where it is installed; without it the text still goes to the
    ``.tqdm`` file."""

    _LAYOUT = ('{desc}{percentage:3.0f}% |{bar}| {n_fmt}/{total_fmt} '
               '[{elapsed}<{remaining}{postfix}]')

    def __init__(self, num_batches, print_interval=1):
        self.total = int(num_batches)
        self._every = max(1, int(print_interval))
        self._calls = 0
        try:
            from tqdm import tqdm
        except ImportError:
            self._bar = None
        else:
            self._bar = tqdm(total=self.total, bar_format=self._LAYOUT)

    def __iter__(self):
        try:
            for index in range(self.total):
                yield index
                if self._bar is not None:
                    self._bar.update()
        finally:
            self.close()

    def advance(self, n):
        """Moves the bar ``n`` batches on (a chain of steps)."""
        if self._bar is not None:
            self._bar.update(n)

    def close(self):
        if self._bar is not None:
            self._bar.close()

    def print(self, mode, epoch, **metrics):
        parts = [f'{mode} | epoch {epoch: >2}']
        if metrics:
            parts.append(': ')
            parts.append(' | '.join(f'{name} = {value}' for name, value in metrics.items()))
        text = ''.join(parts)
        logging.getLogger(LOGGER_NAME).debug(text, extra={'is_tqdm': True})
        if self._bar is not None:
            self._bar.set_description(text)

    def maybe_print(self, mode, epoch, metrics_fn, count=1):
        """Prints when the ``count`` batches just done (a chain's, or one)
        pass a multiple of the print interval."""
        before = self._calls
        self._calls += count
        if self._calls // self._every > before // self._every:
            self.print(mode, epoch, **metrics_fn())
