"""Streaming (online) metrics (counterpart of ``morgana_tpu/metrics.py``).

Each metric splits into :meth:`~StatefulMetric.partials`, device math that
returns small partial statistics (for example a masked sum and its count),
and :meth:`~StatefulMetric.merge`, a host-side update of the accumulator.
:meth:`Handler.accumulate` computes the partials at once, without a
gradient, and keeps them as device tensors; they are merged lazily, with one
host transfer for all that are pending, the next time a result is read. So a
train step causes no host round trip, as the JAX package's staging does
(``metrics.py:133-250``).

A chain of steps (``--steps_per_dispatch`` on the GPU, CUDA graph replays)
writes each step's partials into a row of tensors stacked over the chain;
:meth:`Handler.apply_staged` takes them with ``steps=N`` and merges the rows
in step order, the same as N separate accumulations.

The classes are those that the port's models register and their bases; the
JAX package's other metrics come with the model that first registers them.
"""
from collections.abc import Iterable

import numpy as np
import torch
from torch.utils._pytree import tree_map

from morgana_tpu_torch import utils
from morgana_tpu_torch.ops.masking import sequence_mask

__all__ = [
    'StatefulMetric', 'Handler', 'Mean', 'RMSE', 'F0Distortion', 'LF0Distortion', 'Distortion',
    'MelCepDistortion',
]


def _to_python(value):
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    return value


class _Leaf(object):
    """Marks where a tensor sat in a tree of partials."""

    def __init__(self, index):
        self.index = index


def _to_host(tree):
    """Every tensor in a (nested dict/list of) partials fetched to the host
    as numpy; the scalars of each device are stacked and copied at once."""
    leaves = []

    def collect(node):
        if isinstance(node, dict):
            return {k: collect(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(collect(v) for v in node)
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return _Leaf(len(leaves) - 1)
        return node

    skeleton = collect(tree)
    host = [None] * len(leaves)
    by_device = {}
    for i, leaf in enumerate(leaves):
        if leaf.ndim == 0 and leaf.is_floating_point():
            by_device.setdefault(leaf.device, []).append(i)
        else:
            host[i] = leaf.detach().cpu().numpy()
    for indices in by_device.values():
        values = torch.stack([leaves[i].detach().double() for i in indices]).cpu().numpy()
        for i, value in zip(indices, values):
            host[i] = value

    def fill(node):
        if isinstance(node, _Leaf):
            return host[node.index]
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return node

    return fill(skeleton)


def _tensor(value):
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))


class StatefulMetric(object):
    r"""Abstract online metric: ``reset_state`` / ``accumulate`` / ``result``.
    Subclasses implement :meth:`partials` (device math) and :meth:`merge`
    (host-state update)."""

    def __init__(self, hidden=False):
        self._hidden = hidden
        self.hidden = True

    def reset_state(self, *args):
        self.hidden = True

    def partials(self, *args, **kwargs):
        raise NotImplementedError

    def merge(self, partials):
        raise NotImplementedError

    def accumulate(self, *args, **kwargs):
        self.hidden = self._hidden
        with torch.no_grad():
            partials = self.partials(*args, **kwargs)
        self.merge(_to_host(partials))

    def result(self, *args):
        raise NotImplementedError

    def result_as_json(self, *args):
        return _to_python(self.result(*args))

    def __str__(self):
        return utils.format_float_tensor(self.result())


class Handler(StatefulMetric):
    r"""Named collections of metrics (``all``/``train``/``valid``/``test``),
    ``metrics.py:76``."""

    def __init__(self, **metrics):
        super().__init__(hidden=False)
        self.collections = {'all': metrics, 'train': {}, 'valid': {}, 'test': {}}
        self.metrics = self.collections['all']
        self.add_metrics(('train', 'valid'), **metrics)
        # Accumulated partials awaiting their host merge:
        # [(collection, name, partials, row)], ``row`` None or the row of
        # stacked partials to merge.
        self._pending = []

    def __getitem__(self, name):
        if name in self.collections:
            # Whoever takes a collection is about to read metric state.
            self.flush()
            return self.collections[name]
        raise ValueError(f'No collection found by the name {name}')

    def add_metrics(self, collections=('all',), **kwargs):
        if not isinstance(collections, Iterable) or isinstance(collections, str):
            collections = [collections]
        if 'all' in collections:
            collections = list(self.collections.keys())
        for collection_name in collections:
            self.collections[collection_name].update(kwargs)
        self.metrics.update(kwargs)

    def add_collection(self, collection, from_collections=tuple()):
        if not isinstance(from_collections, Iterable) or isinstance(from_collections, str):
            from_collections = [from_collections]
        self.collections[collection] = {}
        for from_collection in from_collections:
            self[collection].update(self[from_collection])

    def reset_state(self, collection, *args):
        # Pending partials belong to the previous read window.
        self.flush()
        for metric in self[collection].values():
            metric.reset_state()

    def flush(self):
        """Merges every pending partial into its accumulator, with one host
        transfer per device. Called by every read."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        # Stacked partials shared by several rows go to the host once.
        trees, index = [], {}
        for _, _, partials, _ in pending:
            if id(partials) not in index:
                index[id(partials)] = len(trees)
                trees.append(partials)
        values = _to_host(trees)
        for collection, name, partials, row in pending:
            value = values[index[id(partials)]]
            if row is not None:
                value = tree_map(lambda x: x[row] if isinstance(x, np.ndarray) else x, value)
            metric = self.collections[collection][name]
            metric.hidden = metric._hidden
            metric.merge(value)

    def accumulate(self, collection, **kwargs):
        """``name=inputs`` for each metric of ``collection``; ``inputs`` is
        one argument or a list of them, a trailing dict being keyword
        arguments. The partials are computed now, without a gradient, and
        merged at the next read."""
        for metric_name, inputs in kwargs.items():
            inputs = utils.listify(inputs)
            if isinstance(inputs[-1], dict):
                inputs, kwinputs = inputs[:-1], inputs[-1]
            else:
                kwinputs = dict()
            metric = self.collections[collection][metric_name]
            with torch.no_grad():
                partials = metric.partials(*inputs, **kwinputs)
            self._pending.append((collection, metric_name, partials, None))

    def staged(self, since):
        """The partials accumulated since the pending list held ``since``
        entries, taken out of it as ``[(collection, name, partials)]``: a
        captured step's partials, which it writes into stacked rows."""
        taken = self._pending[since:]
        del self._pending[since:]
        return [(collection, name, partials) for collection, name, partials, _ in taken]

    def apply_staged(self, staged, steps=None):
        """Merges staged partials at the next read (``metrics.py:160-175``).
        ``staged`` is ``[(collection, name, partials)]``; with ``steps=N``
        every tensor of the partials is stacked over a leading axis of N
        steps, and the rows merge in step order: the same as N separate
        :meth:`accumulate` calls. ``staged`` may also be a list of N such
        lists, one a step, for a chain whose steps staged different metrics
        (the row of step ``i`` is then row ``i`` of its own list's
        tensors)."""
        if steps is None:
            self._pending.extend((c, n, p, None) for c, n, p in staged)
            return
        per_step = staged if staged and isinstance(staged[0], list) else [staged] * steps
        if len(per_step) != steps:
            raise ValueError(f'apply_staged: {len(per_step)} lists of partials for {steps} steps')
        for row, entries in enumerate(per_step):
            self._pending.extend((c, n, p, row) for c, n, p in entries)

    def result(self, collection='all', *args):
        self.flush()
        return {name: metric.result(*args) for name, metric in self[collection].items()}

    def results_as_json_dict(self, collection='all', prefix=''):
        self.flush()
        return {prefix + name: metric.result_as_json()
                for name, metric in self[collection].items() if not metric.hidden}

    def results_as_str_dict(self, collection='all', prefix=''):
        self.flush()
        return {prefix + name: str(metric)
                for name, metric in self[collection].items() if not metric.hidden}

    def __str__(self):
        d = self.results_as_str_dict('all')
        return ' | '.join(f'{name} = {value}' for name, value in d.items())


class Mean(StatefulMetric):
    r"""Online mean of (optionally masked) values; the masked count is in
    frames."""

    def __init__(self, hidden=False):
        super().__init__(hidden=hidden)
        self.reset_state()

    def reset_state(self, *args):
        StatefulMetric.reset_state(self)
        self.sum = 0.
        self.count = 0.

    def partials(self, tensor, seq_len=None):
        tensor = _tensor(tensor)
        if seq_len is None:
            # A fill, not a copy from the host: a captured step takes it.
            return {'sum': torch.sum(tensor),
                    'count': torch.full((), float(tensor.numel()), device=tensor.device)}
        mask = sequence_mask(seq_len, max_len=tensor.shape[1], dtype=tensor.dtype)
        return {'sum': torch.sum(tensor * mask), 'count': torch.sum(mask)}

    def merge(self, partials):
        # Exact host floats, as the JAX package keeps them.
        self.sum = self.sum + float(np.asarray(partials['sum'], np.float64))
        self.count = self.count + float(np.asarray(partials['count'], np.float64))

    def result(self, *args):
        return float(self.sum) / (float(self.count) + 1e-8)


class RMSE(Mean):
    r"""Online root-mean-squared-error between targets and predictions."""

    def partials(self, target, pred, seq_len=None):
        return Mean.partials(self, (_tensor(target) - _tensor(pred)) ** 2, seq_len)

    def result(self, *args):
        return (float(self.sum) / (float(self.count) + 1e-8)) ** 0.5


class F0Distortion(RMSE):
    r"""F0 RMSE in Hz over frames voiced in both target and prediction."""

    def partials(self, f0_target, f0_pred, is_voiced, seq_len=None):
        f0_target = _tensor(f0_target)
        mask = _tensor(is_voiced).to(f0_target.dtype)
        if seq_len is not None:
            mask = mask * sequence_mask(seq_len, max_len=f0_target.shape[1], dtype=f0_target.dtype)
        square_diff = (f0_target - _tensor(f0_pred)) ** 2
        return {'sum': torch.sum(square_diff * mask), 'count': torch.sum(mask)}


class LF0Distortion(F0Distortion):
    r"""F0 RMSE in Hz computed from log-F0 inputs."""

    def partials(self, lf0_target, lf0_pred, is_voiced, seq_len=None):
        return F0Distortion.partials(self, torch.exp(_tensor(lf0_target)),
                                     torch.exp(_tensor(lf0_pred)), is_voiced, seq_len)


class Distortion(Mean):
    r"""Spectral distortion in dB (per-frame L2 over the feature dim)."""

    log_spec_dB_const = 10. / np.log(10.) * np.sqrt(2.)

    def partials(self, target, pred, seq_len=None):
        square_diff = (_tensor(target) - _tensor(pred)) ** 2
        root_square_diff = torch.sqrt(torch.sum(square_diff, dim=-1, keepdim=True))
        return Mean.partials(self, root_square_diff, seq_len)

    def result(self, *args):
        return Mean.result(self, *args) * self.log_spec_dB_const


class MelCepDistortion(RMSE):
    r"""Mel-cepstral distortion excluding C0."""

    def partials(self, target, pred, seq_len=None):
        return RMSE.partials(self, _tensor(target)[..., 1:], _tensor(pred)[..., 1:],
                             seq_len=seq_len)
