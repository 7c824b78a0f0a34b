"""Training curves from the metrics on disk (the port's copy of
``morgana_tpu/viz/plotting.py``).

Each experiment writes one ``metrics.json`` an epoch under
``{experiments_base}/{name}/{mode}/epoch_{N}/``. These functions read that
layout into epoch-indexed curves and draw them, train solid and valid dashed,
one subplot a metric: for one experiment (``metrics.pdf`` inside it) or
several in colours (under ``plots/``). matplotlib is imported when a figure
is drawn, not with the module: :func:`load_experiment_results` needs only the
files, and :func:`matplotlib_available` says whether the drawing can run.
"""
import importlib.util
import logging
import os
import re
from collections import OrderedDict

from morgana_tpu_torch import utils
from morgana_tpu_torch.data import file_io

__all__ = ['load_experiment_results', 'plot_experiment', 'plot_experiment_set',
           'matplotlib_available']

_EPOCH_DIR = re.compile(r'epoch_(\d+)$')
_MODE_STYLE = {'train': '-', 'valid': '--'}


def matplotlib_available():
    """True when matplotlib can be imported."""
    return importlib.util.find_spec('matplotlib') is not None


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _iter_epoch_metrics(mode_dir):
    """``(epoch, metrics)`` of every epoch recorded under a mode directory,
    in ascending epoch order."""
    if not os.path.isdir(mode_dir):
        return
    found = []
    for entry in os.listdir(mode_dir):
        match = _EPOCH_DIR.search(entry)
        path = os.path.join(mode_dir, entry, 'metrics.json')
        if match and os.path.isfile(path):
            found.append((int(match.group(1)), path))
    for epoch, path in sorted(found):
        yield epoch, file_io.load_json(path)


def load_experiment_results(experiment_name, metric_names='loss', mode='train',
                            experiments_base='experiments'):
    """``{metric_name: OrderedDict(epoch -> value)}`` of one mode of one
    experiment (``plotting.py:47``)."""
    wanted = utils.listify(metric_names)
    curves = OrderedDict((name, OrderedDict()) for name in wanted)
    mode_dir = os.path.join(experiments_base, experiment_name, mode)
    for epoch, metrics in _iter_epoch_metrics(mode_dir):
        for name in wanted:
            if name in metrics:
                curves[name][epoch] = metrics[name]
    return curves


def _numeric_series(curve):
    """The scalar entries of an epoch -> value map as x and y lists."""
    xs, ys = [], []
    for epoch, value in curve.items():
        if isinstance(value, (int, float)):
            xs.append(epoch)
            ys.append(value)
    return xs, ys


def _metric_axes(n_metrics):
    plt = _pyplot()
    fig, axs = plt.subplots(1, n_metrics, figsize=(1 + 5 * n_metrics, 4), squeeze=False)
    return fig, list(axs[0])


def plot_experiment(experiment_name, metric_names='loss', experiments_base='experiments',
                    axs=None, colour=None, add_labels=True, save=False):
    """Train (solid) and valid (dashed) curves, one subplot a metric
    (``plotting.py:80``). ``axs``/``colour`` layer several experiments on
    shared axes; ``save=True`` writes
    ``{experiments_base}/{experiment_name}/metrics.pdf``."""
    wanted = utils.listify(metric_names)
    if axs is None:
        _, axs = _metric_axes(len(wanted))

    for mode, style in _MODE_STYLE.items():
        curves = load_experiment_results(experiment_name, wanted, mode, experiments_base)
        for ax, name in zip(axs, wanted):
            xs, ys = _numeric_series(curves[name])
            label = experiment_name if mode == 'train' else None
            ax.plot(xs, ys, style, c=colour, label=label)
            if add_labels:
                ax.set_xlabel('Epoch number')
                ax.set_ylabel(name)

    if save:
        target = os.path.join(experiments_base, experiment_name, 'metrics.pdf')
        logging.getLogger('morgana_tpu_torch').info('Saving plot of metrics to %s', target)
        fig = axs[0].figure
        fig.savefig(target, bbox_inches='tight')
        _pyplot().close(fig)
    return axs


def plot_experiment_set(experiment_names, metric_names='loss', experiments_base='experiments',
                        file_name=None):
    """Several experiments, one colour each, on shared metric axes, written
    to ``plots/{file_name}`` (``plotting.py:116``)."""
    plt = _pyplot()
    experiment_names = utils.listify(experiment_names)
    wanted = utils.listify(metric_names)

    fig, axs = _metric_axes(len(wanted))
    palette = plt.get_cmap('Set1')
    for rank, name in enumerate(experiment_names):
        plot_experiment(name, wanted, experiments_base, axs=axs,
                        colour=palette(rank / len(experiment_names)), add_labels=rank == 0)

    legend = fig.legend(*axs[0].get_legend_handles_labels(),
                        title='solid = train, dashed = valid', loc='lower center',
                        bbox_to_anchor=(0.5, -0.12), ncol=min(3, len(experiment_names)),
                        fancybox=True)
    plt.setp(legend.get_lines(), linewidth=4.0)

    if file_name:
        target = os.path.join('plots', file_name)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        logging.getLogger('morgana_tpu_torch').info(
            'Saving plot of metrics for multiple experiments to %s', target)
        fig.savefig(target, bbox_extra_artists=(legend,), bbox_inches='tight')
        plt.close(fig)
    return axs
